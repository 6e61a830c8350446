"""Operations the MMDiT sequences need (the reference's FlopCounterMode count of the encoder and every denoiser step) over the traced seconds at the card's bf16 peak, in percent."""

from benchmark.common.readers import mfu_pct


def read(rec):
    return mfu_pct(rec)
