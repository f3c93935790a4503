from tortoise_tpu_torch.text.tokenizer import Tokenizer, load_vocab  # noqa: F401
