"""The port's RNS core: plans, quantizer, residue tensors, the RNS linear."""
