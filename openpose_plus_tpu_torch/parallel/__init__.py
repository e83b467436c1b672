"""Distributed training and serving on `torch.distributed`: process groups,
the device mesh and a rank's slices (`sharding`), and the KungFu strategies
sync-sgd, sma and pair-avg (`kungfu`). One process a rank, started by
`torchrun` or `torch.multiprocessing`."""
