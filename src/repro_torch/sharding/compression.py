"""int8 error-feedback gradient compression: the counterpart of
``repro.sharding.compression``'s single-device half.

``ef_compress_tree`` quantizes each gradient plus its carried error to
int8 on one scale a tensor, hands back the dequantized gradient and keeps
what the grid lost as the next step's error, in f32 in the train state
(``train.init_train_state(compress_grads=True)``). The numbers are the
reference's bit for bit, on the CPU and on the card: the scale is
``max|x| / 127 + 1e-12`` in x's dtype, rounding is half to even
(``torch.round``, as ``jnp.round``), then clipped to ±127. Every division
takes a tensor divisor on x's device: a Python-number divisor lets CUDA
multiply by its reciprocal instead, which can differ in the last bit.

``compressed_psum``, the int8 all-reduce over a process group, comes with
the sharding slice of the port.
"""
from __future__ import annotations

from collections.abc import Mapping

import torch

INT8_MAX = 127.0


def _scale(top: torch.Tensor) -> torch.Tensor:
    """The int8 grid's step for a largest magnitude ``top``."""
    return top / torch.tensor(INT8_MAX, dtype=top.dtype, device=top.device) + 1e-12


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -INT8_MAX, INT8_MAX).to(torch.int8)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(q, scale)``: x as int8 on the grid ``scale = max|x| / 127 +
    1e-12`` (a 0-dim tensor in x's dtype), rounded half to even and clipped
    to ±127."""
    scale = _scale(x.abs().max())
    return _quantize(x, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``q · scale`` in f32."""
    return q.to(torch.float32) * scale


@torch.no_grad()
def ef_compress_tree(grads: Mapping[str, torch.Tensor], errors: Mapping[str, torch.Tensor],
                     groups: Mapping[str, str] | None = None
                     ) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """``(dequantized grads, new errors)`` for name-keyed gradients and the
    f32 errors carried under the same names: each ``grad + error`` (in f32)
    quantized to int8 and back, cast to the gradient's dtype; the new error
    is what the grid lost, in f32.

    Each tensor has its own scale unless ``groups`` maps names to group
    keys: the tensors of one group then share the scale of their largest
    magnitude, as one leaf of a stacked tree would (the train step groups
    the layers that the JAX package stacks into one leaf). The sums are
    made twice, once for the maxima and once to quantize, so no more than
    one tensor's f32 copy is alive beside the results."""
    key = {name: groups[name] if groups is not None else name for name in grads}
    top: dict[str, torch.Tensor] = {}
    for name, g in grads.items():
        m = (g.float() + errors[name]).abs().max()
        top[key[name]] = m if key[name] not in top else torch.maximum(top[key[name]], m)
    scales = {k: _scale(m) for k, m in top.items()}
    deq, err = {}, {}
    for name, g in grads.items():
        gf = g.float() + errors[name]
        scale = scales[key[name]]
        d = dequantize_int8(_quantize(gf, scale), scale)
        deq[name], err[name] = d.to(g.dtype), gf - d
    return deq, err


def init_error_state(params: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Zero f32 errors beside each parameter, on its device."""
    return {name: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for name, p in params.items()}
