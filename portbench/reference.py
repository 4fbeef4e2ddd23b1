"""The plain reference: the configurations' forward, loss, gradients,
momentum update and int8 post-training quantization in plain PyTorch
(float32, TF32 off unless a control asks for it), from the layer table
alone.

It imports neither the program nor JAX: it takes the benchmark's inputs
(:mod:`portbench.inputs`) and works out again whatever the program
derives from them: the dropout masks from the threefry keys
(:mod:`portbench.threefry`, a frozen copy), the int8 weights, their
scales and the activation scales.  The program's outputs reach it only
to be judged (:mod:`portbench.check`).

Layouts: the table's NHWC activations and HWIO / (fan_in, units)
weights; inside, convolutions run NCHW and an fc layer flattens its
input in NHWC order, as the program does.
"""

import contextlib

import numpy
import torch
import torch.nn.functional as F

from portbench import threefry

__all__ = ["tf32", "forward_logits", "train_steps", "quantize",
           "quantized_logits", "as_quantized", "step_key"]


@contextlib.contextmanager
def tf32(enabled):
    """TF32 for float32 products on the card on or off inside the
    block (off is true float32); restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def step_key(dropout_seed, iteration):
    """The threefry key of train step ``iteration`` (from 1):
    ``fold_in(key(dropout_seed), iteration)``."""
    return threefry.fold_in(threefry.key(dropout_seed), iteration)


def _layer(layer, p, h, key=None):
    """One layer on NCHW (conv, pool) or (B, features) activations."""
    s = layer.spec
    if layer.type == "conv":
        w = p["weights"].permute(3, 2, 0, 1)
        h = F.conv2d(h, w, p["bias"], stride=s.get("stride", 1),
                     padding=s["pad"])
        return torch.relu(h)
    if layer.type == "maxpool":
        return F.max_pool2d(h, s["kernel"], s["stride"], ceil_mode=True)
    if layer.type == "dropout":
        if key is None:
            return h
        keep = 1.0 - s["ratio"]
        mask = threefry.bernoulli(threefry.fold_in(key, layer.index), keep,
                                  h.shape, h.device)
        return h * (mask.to(h.dtype) / keep)
    h = _flat(h) @ p["weights"] + p["bias"]
    return h if s["act"] == "softmax" else torch.relu(h)


def _flat(h):
    if h.ndim == 4:  # NCHW -> NHWC order, as the program flattens
        h = h.permute(0, 2, 3, 1)
    return h.reshape(h.shape[0], -1)


def forward_logits(model, params, x, key=None):
    """Logits of NHWC images ``x``; ``key`` draws the dropout masks
    (None: inference, dropout is the identity)."""
    h = x.permute(0, 3, 1, 2)
    for layer, p in zip(model.layers, params):
        h = _layer(layer, p, h, key)
    return h


def _leaves(params):
    return [p[k] for p in params if p["weights"] is not None
            for k in ("weights", "bias")]


def _norms(tensors):
    return [float(torch.linalg.vector_norm(t.double())) for t in tensors]


def train_steps(model, params, batches, dropout_seed, steps=3):
    """``steps`` momentum SGD steps from ``params`` (not modified) over
    ``batches`` [(x, labels)], step i keyed by ``step_key(dropout_seed,
    i)``.  Returns {"loss": [per step], "grad_norms": [the first step's
    gradient, per leaf], "change_norms": [|w_steps - w_0| per leaf]}."""
    lr = model.solver["learning_rate"]
    moment = model.solver["gradient_moment"]
    work = [{k: None if v is None else v.detach().clone()
             for k, v in p.items()} for p in params]
    leaves = _leaves(work)
    velocity = [torch.zeros_like(t) for t in leaves]
    losses, grad_norms = [], None
    for i in range(steps):
        x, labels = batches[i]
        for t in leaves:
            t.requires_grad_(True)
        logits = forward_logits(model, work, x, step_key(dropout_seed,
                                                         i + 1))
        loss = F.cross_entropy(logits, labels.long(),
                               reduction="sum") / x.shape[0]
        grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        if grad_norms is None:
            grad_norms = _norms(grads)
        with torch.no_grad():
            for t, v, g in zip(leaves, velocity, grads):
                t.requires_grad_(False)
                v.mul_(moment).add_(g, alpha=lr)
                t.sub_(v)
        del logits, loss, grads
    change = _norms(t - t0 for t, t0 in zip(leaves, _leaves(params)))
    return {"loss": losses, "grad_norms": grad_norms,
            "change_norms": change}


def _percentile(values, q):
    """``numpy.percentile(values, q)`` (linear) of a flat float32
    tensor, with numpy's float32 arithmetic: the virtual index, the
    weight and the interpolation all in float32 (as numpy computes them
    for a float32 array), from the top ``n - floor(index)`` values."""
    f32 = numpy.float32
    n = values.numel()
    index = f32(q / 100.0) * f32(n - 1)
    lo = int(numpy.floor(index))
    top = torch.topk(values, n - lo, largest=True, sorted=True).values
    a = f32(top[-1].item())
    b = f32(top[-2].item()) if top.numel() > 1 else a
    t = f32(index - f32(lo))
    diff = b - a
    if t >= 0.5:
        return float(b - diff * (f32(1.0) - t))
    return float(a + diff * t)


def quantize(model, params, calib, qmax=127, percentile=99.9, block=16):
    """The post-training quantization of ``params`` on the calibration
    images ``calib``: per output channel ``s_w = max|W| / qmax`` (1.0
    for an all-zero channel), ``W_q = clip(round(W / s_w), -qmax,
    qmax)``; each conv or fc layer's activation scale ``a = P / qmax``,
    P the ``percentile``-th percentile of its input's ``|x|`` over the
    float32 forward.  Returns [{"wq", "ws", "act", "bias"}] (None for
    a layer without parameters)."""
    inputs = {l.index: [] for l in model.param_layers}
    with torch.no_grad():
        for start in range(0, calib.shape[0], block):
            h = calib[start:start + block].permute(0, 3, 1, 2)
            for layer, p in zip(model.layers, params):
                if layer.has_params:
                    inputs[layer.index].append(h.abs().flatten())
                h = _layer(layer, p, h)
    out = []
    for layer, p in zip(model.layers, params):
        if not layer.has_params:
            out.append(None)
            continue
        vals = torch.cat(inputs.pop(layer.index))
        amax = _percentile(vals, percentile)
        del vals
        if amax <= 0:
            amax = 1.0
        w = p["weights"]
        wmax = w.abs().reshape(-1, w.shape[-1]).amax(0)
        ws = torch.where(wmax > 0, wmax / qmax, torch.ones_like(wmax))
        wq = torch.clamp(torch.round(w / ws), -qmax, qmax)
        out.append({"wq": wq, "ws": ws,
                    "act": torch.tensor(amax / qmax, dtype=torch.float32,
                                        device=w.device),
                    "bias": p["bias"], "qmax": qmax})
    return out


def quantized_logits(model, qparams, x, block=32):
    """Logits of the quantized model: each conv or fc layer quantizes
    its input (``clip(round(x / a), -qmax, qmax)``), takes the integer
    product exactly (in float64: every sum of int8 products is an
    integer far below 2**53) and dequantizes in float32 with ``acc *
    (a * s_w) + bias``.  In blocks of ``block`` rows."""
    out = []
    with torch.no_grad():
        for start in range(0, x.shape[0], block):
            out.append(_quantized_block(model, qparams,
                                        x[start:start + block]))
    return torch.cat(out)


def _quantized_block(model, qparams, x):
    h = x.permute(0, 3, 1, 2)
    for layer, q in zip(model.layers, qparams):
        if not layer.has_params:
            h = _layer(layer, None, h)
            continue
        xq = torch.clamp(torch.round(h / q["act"]), -q["qmax"],
                         q["qmax"]).double()
        scale = q["act"] * q["ws"]
        s = layer.spec
        if layer.type == "conv":
            acc = F.conv2d(xq, q["wq"].double().permute(3, 2, 0, 1),
                           stride=s.get("stride", 1), padding=s["pad"])
            h = torch.relu(acc.float() * scale[:, None, None] +
                           q["bias"][:, None, None])
        else:
            h = (_flat(xq) @ q["wq"].double()).float() * scale + q["bias"]
            if s["act"] != "softmax":
                h = torch.relu(h)
    return h


def as_quantized(model, entries, device, qmax=127):
    """A quantized parameter list in another's keys (``weights`` int8,
    ``weights_scale``, ``act_scale``, ``bias``: the program's) as this
    module's, to be compared with :func:`quantize`'s."""
    out = []
    for layer, e in zip(model.layers, entries):
        if not layer.has_params:
            out.append(None)
            continue
        out.append({key: torch.as_tensor(e[src]).to(device).float()
                    for key, src in (("wq", "weights"),
                                     ("ws", "weights_scale"),
                                     ("act", "act_scale"),
                                     ("bias", "bias"))})
        out[-1]["qmax"] = qmax
    return out
