"""TCP serving: N client streams multiplexed onto one batched
StreamingVocoder push (see server.py)."""

from advoc_tpu_torch.serve.client import VocodeClient
from advoc_tpu_torch.serve.server import ServerHandle, VocoderServer, start_in_thread

__all__ = [
    "ServerHandle",
    "VocodeClient",
    "VocoderServer",
    "start_in_thread",
]
