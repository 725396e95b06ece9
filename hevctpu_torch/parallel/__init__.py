from hevctpu_torch.parallel.sharded import (Mesh, ShardedEncoder,  # noqa: F401
                                            make_mesh)
