"""Reference model zoo: the AlexNet, VGG, MNIST-MLP and transformer
layer specs.

Counterpart of ``veles_tpu/models/zoo.py`` (the autoencoder spec waits
for its slice).  :func:`build_plans_and_state`
draws the weights from ``numpy.random.RandomState(seed)`` in the same
order as the JAX version, so one seed gives bit-identical weights in
both packages.  The state it returns is host numpy, in the JAX layouts.
"""

import numpy

from veles_tpu_torch.compiler import LayerPlan
from veles_tpu_torch.models.conv import _norm_padding
from veles_tpu_torch.models.nn_workflow import forward_mapping
from veles_tpu_torch.models.pooling import _out_len
from veles_tpu_torch.models.transformer import init_block_params

__all__ = ["alexnet_layers", "vgg_layers", "mnist_mlp_layers",
           "transformer_layers", "build_plans_and_state"]

_CONV_TYPES = ("conv", "conv_tanh", "conv_relu", "conv_str",
               "conv_sigmoid")
_POOL_TYPES = ("max_pooling", "avg_pooling", "maxabs_pooling")


def build_plans_and_state(specs, input_shape, seed=0):
    """LayerPlans + an initial state list for a spec list;
    ``input_shape`` excludes the batch.  Returns (plans, state, output
    shape)."""
    fmap = forward_mapping()
    rng = numpy.random.RandomState(seed)
    plans, state = [], []
    shape = tuple(input_shape)

    def entry(w_shape, b_shape):
        fan_in = int(numpy.prod(w_shape[:-1]))
        weights = (rng.uniform(-1, 1, w_shape) /
                   numpy.sqrt(fan_in)).astype(numpy.float32)
        return {
            "weights": weights,
            "bias": numpy.zeros(b_shape, numpy.float32),
            "accum_weights": numpy.zeros(w_shape, numpy.float32),
            "accum_bias": numpy.zeros(b_shape, numpy.float32),
            "accum2_weights": None, "accum2_bias": None}

    def none_entry():
        return {"weights": None, "bias": None, "accum_weights": None,
                "accum_bias": None, "accum2_weights": None,
                "accum2_bias": None}

    for spec in specs:
        spec = dict(spec)
        ltype = spec.pop("type")
        if ltype not in fmap:
            raise ValueError("layer type %r is not ported (known: %s)"
                             % (ltype, ", ".join(sorted(fmap))))
        cls = fmap[ltype]
        hyper = {k: spec[k] for k in
                 ("learning_rate", "gradient_moment", "weights_decay",
                  "l1_vs_l2") if k in spec}
        if ltype in _CONV_TYPES:
            k = spec["kx"]
            n = spec["n_kernels"]
            sx, sy = spec.get("sliding", (1, 1))
            left, top, right, bottom = _norm_padding(
                spec.get("padding", 0))
            h, w = shape[0], shape[1]
            ch = shape[2] if len(shape) > 2 else 1
            out_h = (h + top + bottom - spec["ky"]) // sy + 1
            out_w = (w + left + right - k) // sx + 1
            plans.append(LayerPlan(
                cls, hyper=hyper,
                static={"padding": (left, top, right, bottom),
                        "sliding": (sx, sy)}))
            state.append(entry((spec["ky"], k, ch, n), (n,)))
            shape = (out_h, out_w, n)
        elif ltype in _POOL_TYPES:
            kx, ky = spec["kx"], spec["ky"]
            sx, sy = spec.get("sliding", (kx, ky))
            plans.append(LayerPlan(
                cls, include_bias=False,
                static={"window": (ky, kx), "sliding": (sx, sy)}))
            state.append(none_entry())
            shape = (_out_len(shape[0], ky, sy),
                     _out_len(shape[1], kx, sx),
                     shape[2] if len(shape) > 2 else 1)
        elif ltype == "dropout":
            plans.append(LayerPlan(
                cls, include_bias=False,
                static={"dropout_ratio": spec.get("dropout_ratio",
                                                  0.5)}))
            state.append(none_entry())
        elif ltype == "transformer":
            d = shape[-1]
            heads = _heads(spec, d)
            hidden = spec.get("hidden") or 4 * d
            plans.append(LayerPlan(
                cls, hyper=hyper,
                static={"heads": heads, "hidden": hidden,
                        "eps": spec.get("eps", 1e-5)}))
            weights, bias = init_block_params(d, hidden, rng)
            state.append({
                "weights": weights, "bias": bias,
                "accum_weights": numpy.zeros_like(weights),
                "accum_bias": numpy.zeros_like(bias),
                "accum2_weights": None, "accum2_bias": None})
        elif ltype == "attention":
            d = shape[-1]
            plans.append(LayerPlan(
                cls, hyper=hyper, static={"heads": _heads(spec, d)}))
            state.append(entry((d, 4 * d), (4 * d,)))
        elif ltype == "layer_norm":
            d = shape[-1]
            plans.append(LayerPlan(
                cls, hyper=hyper,
                static={"eps": spec.get("eps", 1e-5)}))
            gamma = numpy.ones((d,), numpy.float32)
            state.append({
                "weights": gamma,
                "bias": numpy.zeros((d,), numpy.float32),
                "accum_weights": numpy.zeros_like(gamma),
                "accum_bias": numpy.zeros((d,), numpy.float32),
                "accum2_weights": None, "accum2_bias": None})
        else:  # all2all family
            fan_in = int(numpy.prod(shape))
            out = spec["output_sample_shape"]
            out = int(numpy.prod(out)) if not isinstance(out, int) \
                else out
            plans.append(LayerPlan(cls, hyper=hyper))
            state.append(entry((fan_in, out), (out,)))
            shape = (out,)
    return plans, state, shape


def _heads(spec, d):
    heads = spec.get("heads", 1)
    if d % heads:
        raise ValueError("features %d %% heads %d != 0" % (d, heads))
    return heads


def transformer_layers(blocks=2, heads=2, hidden=None, classes=10,
                       lr=0.05, moment=0.9):
    """Sequence classification: a stack of pre-LN transformer blocks over
    (B, T, D) input and a softmax head over the flattened sequence."""
    spec = [{"type": "transformer", "heads": heads, "hidden": hidden,
             "learning_rate": lr, "gradient_moment": moment}
            for _ in range(blocks)]
    spec.append({"type": "softmax", "output_sample_shape": classes,
                 "learning_rate": lr, "gradient_moment": moment})
    return spec


def mnist_mlp_layers(hidden=100, classes=10, lr=0.1, moment=0.9):
    """The 784-hidden-10 fully-connected net."""
    return [
        {"type": "all2all_tanh", "output_sample_shape": hidden,
         "learning_rate": lr, "gradient_moment": moment},
        {"type": "softmax", "output_sample_shape": classes,
         "learning_rate": lr, "gradient_moment": moment},
    ]


def _conv(n, k, lr, moment, stride=1, pad=None, act="conv_str"):
    spec = {"type": act, "n_kernels": n, "kx": k, "ky": k,
            "learning_rate": lr, "gradient_moment": moment}
    if stride != 1:
        spec["sliding"] = (stride, stride)
    spec["padding"] = (k // 2) if pad is None else pad
    return spec


def _pool(k=3, stride=2):
    return {"type": "max_pooling", "kx": k, "ky": k,
            "sliding": (stride, stride)}


def alexnet_layers(classes=1000, lr=0.01, moment=0.9, dropout=0.5):
    """AlexNet (227x227x3 input)."""
    return [
        _conv(96, 11, lr, moment, stride=4, pad=0),
        _pool(),
        _conv(256, 5, lr, moment),
        _pool(),
        _conv(384, 3, lr, moment),
        _conv(384, 3, lr, moment),
        _conv(256, 3, lr, moment),
        _pool(),
        {"type": "all2all_str", "output_sample_shape": 4096,
         "learning_rate": lr, "gradient_moment": moment},
        {"type": "dropout", "dropout_ratio": dropout},
        {"type": "all2all_str", "output_sample_shape": 4096,
         "learning_rate": lr, "gradient_moment": moment},
        {"type": "dropout", "dropout_ratio": dropout},
        {"type": "softmax", "output_sample_shape": classes,
         "learning_rate": lr, "gradient_moment": moment},
    ]


def vgg_layers(classes=1000, lr=0.01, moment=0.9, dropout=0.5,
               config="D"):
    """VGG (224x224x3).  config "A"=VGG11, "D"=VGG16, "E"=VGG19."""
    plan = {
        "A": [(64, 1), (128, 1), (256, 2), (512, 2), (512, 2)],
        "D": [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)],
        "E": [(64, 2), (128, 2), (256, 4), (512, 4), (512, 4)],
    }[config]
    layers = []
    for channels, repeats in plan:
        for _ in range(repeats):
            layers.append(_conv(channels, 3, lr, moment))
        layers.append(_pool(k=2, stride=2))
    layers += [
        {"type": "all2all_str", "output_sample_shape": 4096,
         "learning_rate": lr, "gradient_moment": moment},
        {"type": "dropout", "dropout_ratio": dropout},
        {"type": "all2all_str", "output_sample_shape": 4096,
         "learning_rate": lr, "gradient_moment": moment},
        {"type": "dropout", "dropout_ratio": dropout},
        {"type": "softmax", "output_sample_shape": classes,
         "learning_rate": lr, "gradient_moment": moment},
    ]
    return layers
