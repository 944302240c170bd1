"""Process mesh and sharding (counterpart of ``pips_tpu/parallel``): one
process per device, a (data, point) ``DeviceMesh`` over them."""

from pips_tpu_torch.parallel.mesh import (batch_pspecs, default_mesh_shape, distributed_init,
                                          make_hybrid_mesh, make_mesh, make_sharded_forward,
                                          make_sharded_train_step, parse_mesh_arg, replicate,
                                          shard_batch)

__all__ = ["batch_pspecs", "default_mesh_shape", "distributed_init", "make_hybrid_mesh",
           "make_mesh", "make_sharded_forward", "make_sharded_train_step", "parse_mesh_arg",
           "replicate", "shard_batch"]
