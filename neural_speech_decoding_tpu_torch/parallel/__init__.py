"""Data parallelism on a one-process device mesh (parallel/mesh.py), with
parameter placement and sharded prediction (sharding.py) and reductions
across shards (collective.py). Counterpart of the JAX package's
parallel/."""

from neural_speech_decoding_tpu_torch.parallel.mesh import make_mesh, mesh_axes  # noqa: F401
from neural_speech_decoding_tpu_torch.parallel.sharding import (  # noqa: F401
    batch_sharding,
    replicate,
    shard_params_tp,
    sharded_predict_fn,
)
