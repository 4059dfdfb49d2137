"""LM training on one device: AdamW (``optimizer``), the train step with
microbatch accumulation and remat (``train_loop``), atomic async
checkpoints in the reference's on-disk layout (``checkpoint``) and the
elastic restart runner (``elastic``)."""
from . import checkpoint, elastic, optimizer, train_loop  # noqa: F401
