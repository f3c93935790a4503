from tortoise_tpu_torch.utils.debug import DumpRegistry, compare_dumps  # noqa: F401
from tortoise_tpu_torch.utils.profiling import trace  # noqa: F401
from tortoise_tpu_torch.utils.progress import progress_bar  # noqa: F401
