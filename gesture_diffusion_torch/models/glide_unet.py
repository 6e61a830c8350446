"""The GLIDE UNet family, channel-first (NCL for dims 1, NCHW for dims 2).

Port of ``gesture_diffusion_tpu/models/glide_unet.py`` (the reference's
``models/modules/glide/unet.py``: ``UNetModel`` :280-527 and the
conditioned variants :528-611), including the branches the gesture path
never takes: 2-D signals, class conditioning by a label embedding, up and
downsampling inside residual blocks (``resblock_updown``), attention heads
by ``num_head_channels`` / ``num_heads_upsample``, encoder keys and values
in every attention block, and scale-shift norm.  GroupNorm statistics are
float32 at least whatever the dtype (``unet_decoder.GroupNorm32``).

``timestep_embedding`` is the published GLIDE formula, which the reference
calls without defining it (``unet.py:509``); it is the denoiser's, whose
frequencies the fused kernel shares.

Module names are the reference's (``time_embed``, ``label_emb``,
``input_blocks``, ``middle_block``, ``output_blocks``, ``out``; a
ResBlock's ``in_layers`` / ``emb_layers`` / ``out_layers`` /
``skip_connection``; an attention block's 1x1 ``Conv1d`` ``qkv``,
``encoder_kv`` and ``proj_out``), so a reference ``state_dict`` loads as it
is.  The conditioned variants are subclasses, as in the reference, and so
carry the same names.  As in the JAX module, the step-embedding MLP and the
label embedding are ``model_channels`` wide.  The residual and attention
blocks and the UNet body are ``models/unet_decoder.py``'s, which the
gesture decoder builds at ``dims=1`` with scale-shift norm.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .denoiser import timestep_embedding
from .unet_decoder import ResBlock, UNet, UNetAttentionBlock

__all__ = ["timestep_embedding", "GlideResBlock", "GlideAttentionBlock",
           "GlideUNet", "SuperResGlideUNet", "InpaintGlideUNet",
           "SuperResInpaintGlideUNet"]

# ``unet.py:96-198`` and ``:201-278``: the decoder's blocks are GLIDE's.
GlideResBlock = ResBlock
GlideAttentionBlock = UNetAttentionBlock


class GlideUNet(UNet):
    """``unet.py:280-527``: the shared ``UNet`` body behind the step
    embedding (``time_embed``) and, with ``num_classes``, a label
    embedding (``label_emb``) added to it."""

    def __init__(self, in_channels: int, model_channels: int,
                 out_channels: int, num_res_blocks: int,
                 attention_resolutions: Sequence[int], dropout: float = 0.0,
                 channel_mult: Sequence[int] = (1, 2, 4, 8),
                 conv_resample: bool = True, dims: int = 2,
                 num_classes: Optional[int] = None, num_heads: int = 1,
                 num_head_channels: int = -1, num_heads_upsample: int = -1,
                 use_scale_shift_norm: bool = False,
                 resblock_updown: bool = False,
                 encoder_channels: Optional[int] = None):
        if dims not in (1, 2):
            raise ValueError(f"dims must be 1 or 2, got {dims}")
        super().__init__(in_channels, model_channels, out_channels,
                         num_res_blocks, attention_resolutions, dropout,
                         channel_mult, conv_resample, dims, num_heads,
                         num_head_channels, num_heads_upsample,
                         use_scale_shift_norm, resblock_updown,
                         encoder_channels)
        mc = model_channels
        self.dims, self.model_channels = dims, mc
        self.num_classes = num_classes
        self.time_embed = nn.Sequential(nn.Linear(mc, mc), nn.SiLU(),
                                        nn.Linear(mc, mc))
        if num_classes is not None:
            self.label_emb = nn.Embedding(num_classes, mc)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                y: Optional[torch.Tensor] = None,
                encoder_out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (N, C, *spatial) with ``dims`` spatial axes; timesteps (N,);
        y (N,) class labels iff the model is class-conditional;
        encoder_out (N, C_enc, T_enc)."""
        if x.dim() != self.dims + 2:
            raise ValueError(f"expected a channel-first rank-{self.dims + 2} "
                             f"input, got {tuple(x.shape)}")
        if (y is not None) != (self.num_classes is not None):
            raise ValueError("pass y iff the model is class-conditional")
        emb = timestep_embedding(timesteps, self.model_channels)
        emb = self.time_embed(emb.to(self.time_embed[0].weight.dtype))
        if self.num_classes is not None:
            emb = emb + self.label_emb(y)
        return super().forward(x, emb, encoder_out)


def _resize_linear(low_res: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(Bi)linear resize of ``low_res`` to ``like``'s spatial size (half-pixel
    centres, the reference's ``F.interpolate(..., mode="bilinear")``)."""
    mode = "linear" if like.dim() == 3 else "bilinear"
    return F.interpolate(low_res, like.shape[2:], mode=mode, align_corners=False)


def _inpaint_inputs(x, inpaint_image, inpaint_mask):
    if inpaint_image is None:
        inpaint_image = torch.zeros_like(x)
    if inpaint_mask is None:
        inpaint_mask = torch.zeros_like(x[:, :1])
    mask = inpaint_mask.expand(x.shape[0], 1, *x.shape[2:])
    return [x, inpaint_image * inpaint_mask, mask]


class SuperResGlideUNet(GlideUNet):
    """``unet.py:528-549``: conditioned on a low-resolution signal,
    resized (bi)linearly to x's size and concatenated on the channels;
    ``in_channels`` is x's, and the UNet takes twice as many."""

    def __init__(self, in_channels: int, *args, **kwargs):
        super().__init__(in_channels * 2, *args, **kwargs)

    def forward(self, x, timesteps, low_res, **kwargs):
        return super().forward(torch.cat([x, _resize_linear(low_res, x)], dim=1),
                               timesteps, **kwargs)


class InpaintGlideUNet(GlideUNet):
    """``unet.py:551-576``: conditioned on a masked signal and its mask."""

    def __init__(self, in_channels: int, *args, **kwargs):
        super().__init__(in_channels * 2 + 1, *args, **kwargs)

    def forward(self, x, timesteps, inpaint_image=None, inpaint_mask=None,
                **kwargs):
        return super().forward(
            torch.cat(_inpaint_inputs(x, inpaint_image, inpaint_mask), dim=1),
            timesteps, **kwargs)


class SuperResInpaintGlideUNet(GlideUNet):
    """``unet.py:578-611``: inpainting and super-resolution conditioning."""

    def __init__(self, in_channels: int, *args, **kwargs):
        super().__init__(in_channels * 3 + 1, *args, **kwargs)

    def forward(self, x, timesteps, inpaint_image=None, inpaint_mask=None,
                low_res=None, **kwargs):
        parts = _inpaint_inputs(x, inpaint_image, inpaint_mask)
        return super().forward(
            torch.cat(parts + [_resize_linear(low_res, x)], dim=1),
            timesteps, **kwargs)
