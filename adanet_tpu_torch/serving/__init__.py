"""Serving plane of the port: publish generations, gate and flip them,
batch requests into fixed buckets, and answer them through a bounded,
admission-controlled front end.

`ServingFrontend(Batcher(ModelPool(model_dir))).start()` serves the
newest healthy generation under `<model_dir>/serving/gen-<t>/`; a later
generation serves only after its canary window (`PoolConfig`).
"""

from adanet_tpu_torch.serving.batcher import (  # noqa: F401
    Batcher,
    BatcherConfig,
    bucket_for,
    pad_batch,
    request_rows,
    split_rows,
)
from adanet_tpu_torch.serving.frontend import (  # noqa: F401
    FrontendConfig,
    ServeResult,
    ServingFrontend,
)
from adanet_tpu_torch.serving.model_pool import (  # noqa: F401
    GenerationRecord,
    ModelPool,
    NoServableGeneration,
    PoolConfig,
)
from adanet_tpu_torch.serving import publisher  # noqa: F401
from adanet_tpu_torch.serving.publisher import publish_generation  # noqa: F401
