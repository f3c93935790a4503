from tortoise_tpu_torch.io.ggml import read_ggml, write_ggml, GGML_MAGIC  # noqa: F401
from tortoise_tpu_torch.io.voice import load_voice_latent  # noqa: F401
from tortoise_tpu_torch.io.wav import write_wav, read_wav  # noqa: F401
