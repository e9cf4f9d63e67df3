"""Channel-sharded RNS launches, the collective-free part of
`repro/dist/`: the CRT tables, the SPMD-uniform local plan, the CRT
finish, and one linear's slice launches composed in one process
(`rns_shard.py`).  The `torch.distributed` layer (the sharded
launch, its communication and the sharded Engine) is not ported yet."""
