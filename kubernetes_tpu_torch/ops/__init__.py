"""Device execution layer: the node-state mirror (`device_state`), per-batch
pod features (`features`) and the hand-written batch kernels with their
plain PyTorch versions (`kernel`, sources in ../csrc)."""
