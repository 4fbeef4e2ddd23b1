"""The quantized forward builder — ``compiler.build_forward``'s int8
twin, as in ``veles_tpu/quant/forward.py``.

Per layer: quantize the f32 activation onto the calibrated grid
(``clip(round(x / act_scale), -127, 127)``), run
:func:`~veles_tpu_torch.ops.matmul_int8.matmul_int8` (all2all layers)
or :func:`~veles_tpu_torch.ops.matmul_int8.conv2d_int8` (conv layers)
with the fused dequant epilogue ``f32(acc) * (act_scale *
weights_scale[c]) + bias``, then the layer's own f32 activation.
Activations carry f32 between layers.  :func:`is_quantized_params` is
how the engine picks this forward: a ``weights_scale`` in any entry.
:func:`with_kmajor_weights` adds to each quantized entry the K-major
copy of its weight that the int8 kernel reads (``weights_kmajor``, made
once when the engine uploads the model); the stored spec and its keys
are untouched.
"""

import functools

import torch

__all__ = ["build_quantized_forward", "f32_layer_apply",
           "is_quantized_entry", "is_quantized_params",
           "quantize_activation", "walk_forward", "with_kmajor_weights"]


def is_quantized_entry(entry):
    """One layer's params carry the quantization pass's artifacts."""
    return entry is not None and entry.get("weights_scale") is not None


def is_quantized_params(params):
    """True when any layer entry is quantized."""
    return any(is_quantized_entry(entry) for entry in params)


def with_kmajor_weights(params):
    """A copy of the device param list in which every quantized entry
    also holds ``weights_kmajor``: its int8 weight as
    :func:`~veles_tpu_torch.ops.matmul_int8.kmajor_weight` gives it, so
    no dispatch transposes a weight.  Costs one more int8 copy of the
    quantized weights in device memory (138 MB for VGG16)."""
    from veles_tpu_torch.ops.matmul_int8 import kmajor_weight
    out = []
    for entry in params:
        entry = dict(entry)
        if is_quantized_entry(entry):
            entry["weights_kmajor"] = kmajor_weight(entry["weights"])
        out.append(entry)
    return out


def quantize_activation(x, act_scale):
    """Activation quantization onto the symmetric grid.
    ``torch.round`` rounds half to even, as ``numpy.rint`` and
    ``jnp.round`` do."""
    from veles_tpu_torch.quant.ptq import QMAX
    q = torch.round(x / act_scale)
    return torch.clamp(q, -QMAX, QMAX).to(torch.int8)


def _apply_quantized(plan, entry, h):
    """One quantized layer: quantize the input, then the int8 kernel
    with the fused dequant and bias."""
    from veles_tpu_torch.models.conv import Conv
    from veles_tpu_torch.ops.matmul_int8 import (conv2d_int8,
                                                 kmajor_weight,
                                                 matmul_int8_kmajor)

    act_scale = entry["act_scale"].to(torch.float32)
    # combined dequant factor, folded here so the epilogue is one FMA
    scale = act_scale * entry["weights_scale"].to(torch.float32)
    bias = entry.get("bias")
    w_kmajor = entry.get("weights_kmajor")
    if issubclass(plan.forward_cls, Conv):
        x = h
        if x.ndim == 3:
            x = x[..., None]
        return conv2d_int8(
            quantize_activation(x, act_scale), entry["weights"],
            scale, bias=bias,
            padding=plan.static.get("padding", (0, 0, 0, 0)),
            sliding=plan.static.get("sliding", (1, 1)), w_kmajor=w_kmajor)
    x2 = h.reshape(h.shape[0], -1)
    if w_kmajor is None:
        w_kmajor = kmajor_weight(entry["weights"])
    return matmul_int8_kmajor(
        quantize_activation(x2, act_scale).contiguous(), w_kmajor, scale,
        bias=bias)


def walk_forward(plans, params, x, layer_fn):
    """The inference layer walk shared by the quantized forward and the
    calibration pass: dropout is skipped (identity at inference) and a
    softmax tail is applied once at the end.  ``layer_fn(i, plan,
    entry, h) -> h`` owns the per-layer arithmetic."""
    from veles_tpu_torch.models.all2all import All2AllSoftmax
    from veles_tpu_torch.models.dropout import DropoutForward

    h = x
    for i, (plan, entry) in enumerate(zip(plans, params)):
        if issubclass(plan.forward_cls, DropoutForward):
            continue
        h = layer_fn(i, plan, entry, h)
    if plans and plans[-1].forward_cls is All2AllSoftmax:
        h = torch.softmax(h, dim=-1)
    return h


def f32_layer_apply(plan, entry, h):
    """One f32 layer with ``build_forward``'s semantics: a softmax
    layer keeps its logits, everything else runs its ``apply``."""
    from veles_tpu_torch.models.all2all import All2All, All2AllSoftmax
    if plan.forward_cls is All2AllSoftmax:
        return All2All.apply(entry, h)
    return functools.partial(plan.forward_cls.apply,
                             **plan.static)(entry, h)


def build_quantized_forward(plans):
    """Pure inference fn(params_list, x) -> output over tensors; entries
    without quantization artifacts run their f32 ``apply``."""
    from veles_tpu_torch.models.all2all import All2AllSoftmax

    def forward(params, x):
        def layer(i, plan, entry, h):
            if not is_quantized_entry(entry):
                return f32_layer_apply(plan, entry, h)
            z = _apply_quantized(plan, entry, h)
            if plan.forward_cls is All2AllSoftmax:
                return z  # keep logits; softmax applied at the tail
            return plan.forward_cls._activate(z).to(torch.float32)

        return walk_forward(plans, params, x, layer)
    return forward
