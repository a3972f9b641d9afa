"""Multi-device product mode through `torch.distributed` (the
counterpart of ``loam_livox_tpu/parallel``): the mesh as a process
group, the sharded kNN and normal equations, the state layout."""
