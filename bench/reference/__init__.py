"""Plain float32 PyTorch references, one module a family. They import
nothing of the port and compute everything again from the weights and
inputs the benchmark made; TF32 is off while they run."""
import contextlib

import torch


@contextlib.contextmanager
def plain_f32(tf32: bool = False):
    """Matrix products in full float32 (``tf32`` False), restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded through float8 e4m3 with one scale per slice along
    ``dim`` (the slice's largest magnitude maps to 448), back in float32:
    the precision of an fp8 matrix product's operands."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    s = amax / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def draw(gen: torch.Generator, shape, dtype, device, scale=1.0,
         shift=0.0, kind="normal") -> torch.Tensor:
    """One large draw from ``gen`` on ``device`` in ``dtype``:
    ``shift + scale * N(0, 1)``, or uniform on [0, 1)."""
    if kind == "uniform":
        return torch.rand(shape, generator=gen, device=device, dtype=dtype)
    t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    t.mul_(scale)
    if shift:
        t.add_(shift)
    return t


def leaves(tree, prefix=""):
    """``(path, tensor)`` of a tree of nested dicts, keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree
