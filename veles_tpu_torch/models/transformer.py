"""Transformer layers: LayerNorm, MultiHeadAttention, TransformerBlock.

Counterpart of the forward half of ``veles_tpu/models/transformer.py``.
The pure functions keep the JAX names, layouts and op order:

- parameters pack as on the JAX side: ``MultiHeadAttention`` stores
  (D, 4D) = [Wq | Wk | Wv | Wo] and (4D,) biases, ``TransformerBlock``
  one flat f32 weights vector and one flat bias vector with static
  offsets (:func:`block_param_sizes`), so one state list serves both
  packages;
- blocks are pre-LN (``h = x + MHA(LN1(x)); y = h + ReLU(LN2(h) W1 + b1)
  W2 + b2``) over (B, T, D) activations;
- the products are ``torch.matmul`` in f32 (``Device()`` turns TF32
  off, so they are true f32 on the card), and the layer norm is written
  out with f32 statistics and ``(x - mu) * (1 / sqrt(var + eps))``, not
  ``F.layer_norm``, so that it rounds as the JAX one does;
- the attention is always :func:`veles_tpu_torch.ops.attention.
  flash_attention`: the device picks the kernels or their plain
  versions, and autograd runs its hand-written backward.  The JAX
  package's ``VELES_PALLAS_BWD`` knob has no counterpart.

A forward class is a unit (``models/nn_units.py``) with a pure
``apply(params, x, **static)``: its unit half sizes its output and
draws its weights from the unit's numpy PRNG in the JAX package's order
at initialize.  The gradient-descent units (:class:`GDLayerNorm`,
:class:`GDMultiHeadAttention`, :class:`GDTransformerBlock`) take
``torch.autograd.grad`` over the forward class's ``apply`` on (W, b, x),
where the JAX package takes ``jax.vjp``: on the card that recomputes
the attention forward (the ``attention_fwd`` kernel) and runs the
``attention_dq`` and ``attention_dkv`` kernels through the flash
attention's backward.  A fused ``StandardWorkflow`` differentiates the
same ``apply`` in its train step.
"""

import numpy
import torch

from veles_tpu_torch.models.nn_units import ForwardBase, GradientDescentBase
from veles_tpu_torch.ops.attention import flash_attention

__all__ = ["LayerNorm", "MultiHeadAttention", "TransformerBlock",
           "GDLayerNorm", "GDMultiHeadAttention", "GDTransformerBlock",
           "layer_norm", "multi_head_attention", "attention_heads",
           "position_wise_mlp", "block_param_sizes",
           "split_block_params", "transformer_block", "init_block_params"]


def _dense(x, w):
    """x (B, T, F) @ w (F, G) in f32."""
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


def layer_norm(x, gamma, beta, eps=1e-5):
    """Per-token normalization over the feature axis, f32 statistics."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * (1.0 / torch.sqrt(var + eps))
    return (y * gamma + beta).to(x.dtype)


def attention_heads(x, w_qkv, b_qkv, heads):
    """QKV projection, per-head attention and head merge over (B, T, *);
    returns the merged (B, T, width / 3) activations in x's dtype,
    before the output projection.  The head dim comes from the
    projection width."""
    b, t = x.shape[0], x.shape[1]
    dh = w_qkv.shape[1] // 3 // heads
    z = _dense(x, w_qkv).to(x.dtype)
    if b_qkv is not None:
        z = z + b_qkv.to(x.dtype)
    q, k, v = torch.chunk(z, 3, dim=-1)

    def fold(a):  # (B, T, H*dh) -> (B*H, T, dh), contiguous for the kernel
        a = a.reshape(b, t, heads, dh)
        return a.permute(0, 2, 1, 3).reshape(b * heads, t, dh).contiguous()

    o = flash_attention(fold(q), fold(k), fold(v))
    return o.reshape(b, heads, t, dh).permute(0, 2, 1, 3).reshape(
        b, t, heads * dh)


def position_wise_mlp(x, w1, b1, w2):
    """ReLU(x W1 + b1) W2 in f32, before the final bias."""
    z = torch.relu(_dense(x, w1) + b1)
    return _dense(z.to(x.dtype), w2)


def multi_head_attention(x, w_qkv, b_qkv, w_o, b_o, heads):
    """Multi-head scaled-dot-product attention over (B, T, D): one packed
    QKV projection, heads folded into the leading dim for the kernel,
    merged output projection."""
    o = attention_heads(x, w_qkv, b_qkv, heads)
    out = _dense(o, w_o)
    if b_o is not None:
        out = out + b_o
    return out.to(x.dtype)


def block_param_sizes(d, hidden):
    """(name, shape) layout of one TransformerBlock's packed weights and
    bias vectors."""
    weights = [("ln1_gamma", (d,)), ("w_qkv", (d, 3 * d)),
               ("w_o", (d, d)), ("ln2_gamma", (d,)),
               ("w1", (d, hidden)), ("w2", (hidden, d))]
    bias = [("ln1_beta", (d,)), ("b_qkv", (3 * d,)), ("b_o", (d,)),
            ("ln2_beta", (d,)), ("b1", (hidden,)), ("b2", (d,))]
    return weights, bias


def _unpack(vec, layout):
    pieces, offset = {}, 0
    for name, shape in layout:
        size = int(numpy.prod(shape))
        pieces[name] = vec[offset:offset + size].reshape(shape)
        offset += size
    return pieces


def split_block_params(weights, bias, d, hidden):
    """Packed flat (weights, bias) -> name -> tensor dicts (views)."""
    w_layout, b_layout = block_param_sizes(d, hidden)
    return _unpack(weights, w_layout), _unpack(bias, b_layout)


def transformer_block(x, w, b, *, heads, hidden, eps=1e-5):
    """One pre-LN block over packed flat params:
    ``h = x + MHA(LN1(x)); y = h + ReLU(LN2(h) W1 + b1) W2 + b2``."""
    d = x.shape[-1]
    wp, bp = split_block_params(w, b, d, hidden)
    h = x + multi_head_attention(
        layer_norm(x, wp["ln1_gamma"], bp["ln1_beta"], eps),
        wp["w_qkv"], bp["b_qkv"], wp["w_o"], bp["b_o"], heads)
    z = position_wise_mlp(
        layer_norm(h, wp["ln2_gamma"], bp["ln2_beta"], eps),
        wp["w1"], bp["b1"], wp["w2"]) + bp["b2"]
    return (h + z.to(x.dtype)).to(x.dtype)


def _uniform(rng, shape, fan_in):
    bound = 1.0 / numpy.sqrt(fan_in) if fan_in else 0.01
    return rng.uniform(-bound, bound, shape).astype(numpy.float32)


def init_block_params(d, hidden, rng):
    """Packed (weights, bias) host init: LN gains 1, matrices
    1/sqrt(fan_in) uniform drawn from ``rng`` in layout order, every
    bias and beta 0 — the JAX package's draws, bit for bit."""
    w_layout, b_layout = block_param_sizes(d, hidden)
    pieces = []
    for name, shape in w_layout:
        if name.endswith("gamma"):
            pieces.append(numpy.ones(shape, numpy.float32))
        else:
            pieces.append(_uniform(rng, shape, shape[0]).ravel())
    weights = numpy.concatenate([p.ravel() for p in pieces])
    bias = numpy.zeros(sum(int(numpy.prod(s)) for _, s in b_layout),
                       numpy.float32)
    return weights, bias


class _SequenceUnit(ForwardBase):
    """Shared (B, T, D)-preserving unit plumbing: the output shape
    mirrors the input, the feature dim comes from the linked input at
    initialize."""

    def _seq_shape(self):
        if not self.input or self.input.sample_size == 0:
            raise AttributeError(
                "%s: input shape unknown at initialize" % self.name)
        shape = self.input.shape
        if len(shape) != 3:
            raise ValueError(
                "%s expects (batch, time, features) input, got %s"
                % (type(self).__name__, (shape,)))
        return shape

    def _ensure_output(self, shape):
        if not self.output:
            self.output.mem = numpy.zeros(shape, numpy.float32)


class LayerNorm(_SequenceUnit):
    """y = gamma * (x - mean) / sqrt(var + eps) + beta over the feature
    axis; weights = gamma, bias = beta."""

    MAPPING = "layer_norm"

    def __init__(self, workflow, **kwargs):
        super(LayerNorm, self).__init__(workflow, **kwargs)
        self.eps = kwargs.get("eps", 1e-5)

    def static_config(self):
        return {"eps": self.eps}

    def create_params(self):
        shape = self._seq_shape()
        self._ensure_output(shape)
        if self.weights:
            return
        d = shape[-1]
        self.weights.mem = numpy.ones((d,), numpy.float32)
        if self.include_bias:
            self.bias.mem = numpy.zeros((d,), numpy.float32)

    @classmethod
    def apply(cls, params, x, *, eps=1e-5):
        bias = params.get("bias")
        beta = torch.zeros((), dtype=x.dtype, device=x.device) \
            if bias is None else bias
        return layer_norm(x, params["weights"], beta, eps)


class MultiHeadAttention(_SequenceUnit):
    """Multi-head attention, (B, T, D) -> same; weights pack (D, 4D) =
    [Wq | Wk | Wv | Wo], bias (4D,)."""

    MAPPING = "attention"

    def __init__(self, workflow, **kwargs):
        super(MultiHeadAttention, self).__init__(workflow, **kwargs)
        self.heads = kwargs.get("heads", 1)

    def static_config(self):
        return {"heads": self.heads}

    def create_params(self):
        shape = self._seq_shape()
        d = shape[-1]
        if d % self.heads:
            raise ValueError("features %d %% heads %d != 0"
                             % (d, self.heads))
        self._ensure_output(shape)
        if self.weights:
            return
        weights = numpy.zeros((d, 4 * d), numpy.float32)
        self.fill_array(weights, self.weights_filling,
                        self.weights_stddev, d)
        self.weights.mem = weights
        if self.include_bias:
            self.bias.mem = numpy.zeros((4 * d,), numpy.float32)

    @classmethod
    def apply(cls, params, x, *, heads):
        d = x.shape[-1]
        w = params["weights"]
        b = params.get("bias")
        return multi_head_attention(
            x, w[:, :3 * d], None if b is None else b[:3 * d],
            w[:, 3 * d:], None if b is None else b[3 * d:], heads)


class TransformerBlock(_SequenceUnit):
    """One pre-LN transformer block packed into one flat (weights, bias)
    pair (:func:`block_param_sizes`)."""

    MAPPING = "transformer"

    def __init__(self, workflow, **kwargs):
        super(TransformerBlock, self).__init__(workflow, **kwargs)
        self.heads = kwargs.get("heads", 1)
        self.hidden = kwargs.get("hidden")
        self.eps = kwargs.get("eps", 1e-5)

    def static_config(self):
        return {"heads": self.heads, "hidden": self.hidden,
                "eps": self.eps}

    def create_params(self):
        shape = self._seq_shape()
        d = shape[-1]
        if self.hidden is None:
            self.hidden = 4 * d
        if d % self.heads:
            raise ValueError("features %d %% heads %d != 0"
                             % (d, self.heads))
        self._ensure_output(shape)
        if self.weights:
            return
        w_layout, b_layout = block_param_sizes(d, self.hidden)
        pieces = []
        for name, piece_shape in w_layout:
            if name.endswith("gamma"):
                pieces.append(numpy.ones(piece_shape, numpy.float32))
            else:
                arr = numpy.zeros(piece_shape, numpy.float32)
                self.fill_array(arr, self.weights_filling,
                                self.weights_stddev, piece_shape[0])
                pieces.append(arr)
        self.weights.mem = numpy.concatenate([p.ravel() for p in pieces])
        if self.include_bias:
            self.bias.mem = numpy.zeros(
                sum(int(numpy.prod(s)) for _, s in b_layout),
                numpy.float32)

    @classmethod
    def apply(cls, params, x, *, heads, hidden, eps=1e-5):
        return transformer_block(x, params["weights"], params["bias"],
                                 heads=heads, hidden=hidden, eps=eps)


# -- gradient-descent units --------------------------------------------------


class _GDAutodiff(GradientDescentBase):
    """The backward is ``torch.autograd.grad`` over FORWARD_CLS.apply on
    (W, b, x), then the solver step of the weights and the unregularized
    bias and the skip-step guard, as the JAX package's vjp backward
    does."""

    MAPPING = None  # abstract
    FORWARD_CLS = None

    @classmethod
    def backward(cls, state, hyper, x, y, err_output, *, solver,
                 include_bias, need_err_input, **static):
        w = state["weights"].detach().requires_grad_(True)
        b = state["bias"] if include_bias else None
        if b is not None:
            b = b.detach().requires_grad_(True)
        x = x.detach().requires_grad_(need_err_input)
        wrt = [t for t in (w, b) if t is not None] + (
            [x] if need_err_input else [])
        with torch.enable_grad():
            out = cls.FORWARD_CLS.apply({"weights": w, "bias": b}, x,
                                        **static)
            grads = list(torch.autograd.grad(out, wrt,
                                             err_output.to(y.dtype)))
        grad_w = grads.pop(0)
        grad_b = grads.pop(0) if b is not None else None
        err_input = grads.pop(0) if need_err_input else None
        new_state = GradientDescentBase.descend(
            state, hyper, solver, grad_w, grad_b, regularize_bias=False)
        return err_input, new_state


class GDLayerNorm(_GDAutodiff):
    MAPPING = "layer_norm"
    FORWARD_CLS = LayerNorm

    def __init__(self, workflow, **kwargs):
        super(GDLayerNorm, self).__init__(workflow, **kwargs)
        self.eps = kwargs.get("eps", 1e-5)

    def backward_static(self):
        return {"eps": self.eps}


class GDMultiHeadAttention(_GDAutodiff):
    MAPPING = "attention"
    FORWARD_CLS = MultiHeadAttention

    def __init__(self, workflow, **kwargs):
        super(GDMultiHeadAttention, self).__init__(workflow, **kwargs)
        self.heads = kwargs.get("heads", 1)

    def backward_static(self):
        return {"heads": self.heads}


class GDTransformerBlock(_GDAutodiff):
    MAPPING = "transformer"
    FORWARD_CLS = TransformerBlock

    def __init__(self, workflow, **kwargs):
        super(GDTransformerBlock, self).__init__(workflow, **kwargs)
        self.heads = kwargs.get("heads", 1)
        self.hidden = kwargs.get("hidden")
        self.eps = kwargs.get("eps", 1e-5)

    def backward_static(self):
        if self.hidden is None:
            # the forward resolved hidden = 4 D at initialize; the packed
            # length L = 2 D + 4 D^2 + 2 D hidden (the weights linked
            # from the forward) determines it
            d = self.input.shape[-1]
            packed = int(numpy.prod(self.weights.shape))
            self.hidden = (packed - 2 * d - 4 * d * d) // (2 * d)
        return {"heads": self.heads, "hidden": self.hidden,
                "eps": self.eps}
