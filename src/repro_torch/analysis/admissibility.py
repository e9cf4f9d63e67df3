"""Kernel admissibility pass — launch choices proven before they run; port of
`repro/analysis/admissibility.py`.

A tile-kernel launch can be *numerically* sound (the bound pass) and still
impossible: a tile height that is not compiled, a K split the cluster
cannot take or that leaves a block without a K step, the 32-row tile on a
basis wider than its instances or on operands it cannot read four at a
time, a block's shared memory past the card's 227 KB, a channel whose
modulus does not fit the 15-bit Horner tables, a committed tune-table row
`tune.blocks_for` would hand to the launcher.  This pass proves each
``(tm, splits)`` against the same constants the launch uses
(`tune.inadmissible`: `tune.smem_footprint`, ``MAX_SPLITS``,
``_MMA_MAXC``; `multiword.MAX_HORNER_MODULUS`), so it cannot drift from
the kernel.

The kernel pads the output grid to whole 64-column tiles; gross padding is
a warning, not an error.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

from repro_torch.core import multiword as mw
from repro_torch.kernels import tune

from .findings import Report

__all__ = ["check_launch", "check_basis_tables", "check_tune_table",
           "check_config_launches"]

Blocks = Tuple[int, int]
_TN = 64                     # the tile's output columns


def check_launch(M: int, K: int, N: int, C: int, blocks: Blocks, *,
                 dtype: str = "int8", x_channels: bool = False,
                 encoded: bool = True, subject: str = "launch") -> Report:
    """Prove one (shape, (tm, splits)) pair admissible for the tile
    kernel.  ``dtype`` (the A operand's) and ``x_channels`` select the A
    mode, ``encoded`` the weight form; the epilogue sizes nothing (every
    one shares the operand stages), so unlike the reference's check there
    is no ``emit``."""
    rep = Report(subject=f"admissibility:{subject}")
    tm, splits = (int(b) for b in blocks)
    amode = tune.amode_for(dtype, x_channels)
    for why in tune.inadmissible((tm, splits), M, K, N, C, amode=amode,
                                 encoded=encoded):
        rep.add("admissibility", f"blocks=({tm}, {splits}) C={C} "
                f"M{M}xK{K}xN{N}", why)
    padded = M * (-(-N // _TN) * _TN)
    if M > 0 and N > 0 and padded > 4 * M * N:
        rep.add("admissibility", f"blocks=({tm}, {splits}) shape=M{M}xN{N}",
                f"padding inflates the output grid {padded / (M * N):.1f}x "
                f"— the tile is {_TN} columns wide", severity="warning")
    return rep


def check_basis_tables(moduli: Sequence[int], *,
                       subject: str = "basis") -> Report:
    """Plan-table admissibility of a channel basis.

    The kernels' per-channel fold constants and the MRC limb Horner walk
    are built for moduli ``m <= 2^15`` (`multiword.MAX_HORNER_MODULUS`); a
    wider channel cannot be reversed on the device, so it is an error.
    """
    rep = Report(subject=f"admissibility:{subject}")
    for m in moduli:
        m = int(m)
        if m < 2:
            rep.add("admissibility", f"channel m={m}",
                    "modulus below 2 carries no information")
        elif m > mw.MAX_HORNER_MODULUS:
            rep.add("admissibility", f"channel m={m}",
                    f"modulus exceeds the 15-bit Horner limit "
                    f"2^15={mw.MAX_HORNER_MODULUS} — reverse conversion "
                    f"cannot stay on device")
    return rep


def check_tune_table(table: Mapping[str, object], *,
                     subject: str = "tune_table") -> Report:
    """Validate every row of a tune table: parseable key, a [tm, splits]
    pair of ints, admissible for the variant and shape the key names."""
    rep = Report(subject=f"admissibility:{subject}")
    for key, val in table.items():
        try:
            parsed = tune.parse_shape_key(key)
        except ValueError as e:
            rep.add("admissibility", f"key {key!r}", str(e))
            continue
        if (not isinstance(val, (list, tuple)) or len(val) != 2
                or not all(isinstance(v, int) and not isinstance(v, bool)
                           for v in val)):
            rep.add("admissibility", f"key {key!r}",
                    f"entry {val!r} is not a [tm, splits] pair of ints")
            continue
        rep.extend(check_launch(
            parsed["M"], parsed["K"], parsed["N"], parsed["C"], tuple(val),
            dtype=parsed["dtype"], x_channels=parsed["x_channels"],
            encoded=parsed["encoded"], subject=key))
    return rep


def check_config_launches(cfg, *, batch_sizes: Optional[Sequence[int]] = None
                          ) -> Report:
    """Admissibility of every decode launch a config's serving path makes.

    Enumerates the shapes `Engine.__init__` warms (`tune.decode_shapes_for`)
    and proves each one's resolved choice (the table's row, else the static
    rule; nothing is swept) admissible.
    """
    rep = Report(subject=f"admissibility:{getattr(cfg, 'name', cfg)}")
    kwargs = {} if batch_sizes is None else {"batch_sizes": batch_sizes}
    for s in tune.decode_shapes_for(cfg, **kwargs):
        blocks = tune.blocks_for(
            s["M"], s["K"], s["N"], s["C"], dtype=s["dtype"],
            backend=s["backend"], sweep=False)
        rep.extend(check_launch(
            s["M"], s["K"], s["N"], s["C"], blocks, dtype=s["dtype"],
            x_channels=s["x_channels"], encoded=s["encoded"],
            subject=f"{s['backend']} M{s['M']}xK{s['K']}xN{s['N']}"))
    return rep
