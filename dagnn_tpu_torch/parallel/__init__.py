"""Data-parallel and edge-partitioned training over torch.distributed
(the JAX package's dagnn_tpu/parallel): process groups as a mesh
(mesh.py), the collectives (comm.py), data parallelism (dp.py) and the
edge-partitioned wavefront (edge_partition.py)."""
