from ptgnn_tpu_torch.sequence.grucopydecoder import (
    DecoderData,
    GruCopyingDecoder,
    GruCopyingDecoderModel,
    TokenizedOutput,
)
from ptgnn_tpu_torch.sequence.luongattention import LuongAttentionModule

__all__ = [
    "DecoderData",
    "GruCopyingDecoder",
    "GruCopyingDecoderModel",
    "TokenizedOutput",
    "LuongAttentionModule",
]
