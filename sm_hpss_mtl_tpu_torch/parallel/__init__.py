"""Multi-device runs (counterpart of the JAX package's ``parallel``): device
meshes, data-parallel training over ``torch.distributed``, time-sharded
HPSS and the time-sharded fused front end (K1 and K2 in halo mode)."""

from .distributed import (initialize_from_env, per_process_seed,  # noqa: F401
                          process_file_shard)
from .dp import make_dp_train_step, replicate, shard_batch  # noqa: F401
from .frontend_shard import (featuregram_time_sharded,  # noqa: F401
                             stft_hpss_mel_time_sharded)
from .halo import hpss_time_sharded  # noqa: F401
from .mesh import (Mesh, NamedSharding, batch_sharding,  # noqa: F401
                   make_mesh, model_sharding, replicated, time_sharding)
