"""progressivenet-cnn [cnn]: the paper's own model family, a small
depthwise-separable convolutional classifier (a MobileNetV2-lite stand-in)
that the paper's Table II measures against received bits.

Counterpart of ``src/repro/configs/progressivenet_cnn.py``. ``CONFIG`` is
the reference's ``ArchConfig`` field for field (the launcher builds the
decoder it describes, as the reference's does); the CNN itself is
:func:`cnn_init` and :func:`cnn_apply`. Its parameters are a flat dict of
float32 leaves in the reference's layouts (HWIO kernels), so ``divide``,
the wire, the client and the store carry it as they carry any tree, byte
for byte the reference's; only :func:`cnn_apply` permutes the kernels
into PyTorch's (O, I, H, W). Progressive inference classifies from the
leaves a client has materialised at each stage (a flat dict's leaves
come back under their own names)::

    prog = divide(cnn_init(torch.Generator(device="cuda").manual_seed(0)))
    client = ProgressiveClient()
    client.feed(wire.encode(prog)[:n])        # any prefix of the stream
    logits = cnn_apply(client.materialize(), images)   # images NHWC
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="progressivenet-cnn",
    family="cnn",
    n_layers=4,
    d_model=64,
    n_heads=1,
    n_kv=1,
    d_ff=128,
    vocab=10,  # n_classes
    cycle=("attn",),  # unused by the CNN, which has its own init and apply
)

BN_EPS = 1e-5


def cnn_init(generator: torch.Generator, *, channels=(16, 32, 64), n_classes: int = 10,
             in_ch: int = 3, device="cuda") -> dict:
    """Random parameters from ``generator`` (which must live on
    ``device``): for each width a depthwise kernel (3, 3, 1, C_prev) at
    scale 0.3 and a pointwise kernel (1, 1, C_prev, C) at He-like scale,
    a batch norm's scale (ones) and bias (zeros); then ``head`` (C,
    n_classes). The reference's keys, shapes, dtypes and scales; its
    values come from JAX's generator, so they differ."""
    device = resolve_device(device)
    params = {}
    prev = in_ch
    for i, ch in enumerate(channels):
        params[f"conv{i}_dw"] = 0.3 * torch.randn((3, 3, 1, prev), generator=generator,
                                                  device=device)
        params[f"conv{i}_pw"] = (2.0 / (prev + ch)) ** 0.5 * torch.randn(
            (1, 1, prev, ch), generator=generator, device=device)
        params[f"bn{i}_scale"] = torch.ones((ch,), device=device)
        params[f"bn{i}_bias"] = torch.zeros((ch,), device=device)
        prev = ch
    params["head"] = (2.0 / (prev + n_classes)) ** 0.5 * torch.randn(
        (prev, n_classes), generator=generator, device=device)
    return params


@contextlib.contextmanager
def _float32(x: torch.Tensor):
    """IEEE float32 convolutions and matmuls on a card for the block's
    duration: cuDNN runs float32 convolutions in TF32 by default on
    Hopper (``torch.backends.cudnn.allow_tf32``), the reference computes
    float32. Both TF32 switches are set off and put back as they were on
    exit, so no other code inherits the change (it is a process setting
    while the block runs: do not run other CUDA work on another thread
    meanwhile). Nothing to do on the CPU."""
    if x.device.type != "cuda":
        yield
        return
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = conv, mm


def cnn_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C) NHWC -> logits (B, n_classes), the reference's
    function in float32: for each width a 3x3 depthwise convolution
    (``SAME``, stride 1: padding 1), a 1x1 pointwise convolution at stride
    2 (``SAME`` at 1x1 pads nothing: ``ceil(H / 2)`` rows out), a norm
    over the batch's own statistics (the population variance, so a logit
    depends on the whole batch), scale and bias, ReLU; then a global
    average pool and the linear head. Runs where ``x`` lies, in IEEE
    float32 on a card (:func:`_float32`)."""
    h = x.permute(0, 3, 1, 2)   # NCHW
    with _float32(h):
        i = 0
        while f"conv{i}_dw" in params:
            h = F.conv2d(h, params[f"conv{i}_dw"].permute(3, 2, 0, 1), padding=1,
                         groups=h.shape[1])
            h = F.conv2d(h, params[f"conv{i}_pw"].permute(3, 2, 0, 1), stride=2)
            mu = h.mean(dim=(0, 2, 3), keepdim=True)
            var = h.var(dim=(0, 2, 3), keepdim=True, correction=0)
            h = (h - mu) * torch.rsqrt(var + BN_EPS)
            h = h * params[f"bn{i}_scale"][:, None, None] + params[f"bn{i}_bias"][:, None, None]
            h = torch.relu(h)
            i += 1
        return h.mean(dim=(2, 3)) @ params["head"]
