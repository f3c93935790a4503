from tortoise_tpu_torch.rng.reference import ReferenceRng  # noqa: F401
from tortoise_tpu_torch.rng.mt19937 import MT19937, PyStdRng  # noqa: F401
