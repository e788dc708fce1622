"""Fits over a mesh of ranks on torch.distributed (counterpart of
matlab_code_tpu/parallel/): sharding.py (the mesh, the layouts, device_put),
collectives.py (psum, all_gather, the ring step), shard_mttkrp.py (the
sharded MTTKRPs on the card's kernels) and distributed.py (the runtime:
initialize, make_global_mesh, globalize, fetch)."""
