"""A configuration's layer table and the shapes that follow from it.

A configuration file (``portbench/configs/<name>.json``) lists its
layers as plain sizes: ``conv`` (filters, kernel, stride, pad, act),
``maxpool`` (kernel, stride, ceil mode), ``fc`` (units, act) and
``dropout`` (ratio).  Activations are NHWC, conv weights HWIO and fc
weights (fan_in, units), the layouts the program takes.  Nothing here
imports the program.
"""

import json
import math

__all__ = ["Layer", "Model", "load_config"]


class Layer(object):
    """One row of the table with its input and output shapes (per
    image, NHWC without the batch)."""

    def __init__(self, index, spec, in_shape):
        self.index = index
        self.spec = dict(spec)
        self.type = spec["type"]
        self.in_shape = tuple(in_shape)
        h, w, c = (self.in_shape + (1, 1))[:3] if len(self.in_shape) < 3 \
            else self.in_shape
        if self.type == "conv":
            k, s, p = spec["kernel"], spec.get("stride", 1), spec["pad"]
            oh = (h + 2 * p - k) // s + 1
            ow = (w + 2 * p - k) // s + 1
            self.out_shape = (oh, ow, spec["filters"])
            self.weight_shape = (k, k, c, spec["filters"])
            self.fan_in = k * k * c
        elif self.type == "maxpool":
            k, s = spec["kernel"], spec["stride"]
            self.out_shape = (_pool_len(h, k, s), _pool_len(w, k, s), c)
            self.weight_shape = None
            self.fan_in = 0
        elif self.type == "fc":
            self.fan_in = int(math.prod(self.in_shape))
            self.out_shape = (spec["units"],)
            self.weight_shape = (self.fan_in, spec["units"])
        elif self.type == "dropout":
            self.out_shape = self.in_shape
            self.weight_shape = None
            self.fan_in = 0
        else:
            raise ValueError("layer %d: unknown type %r" % (index,
                                                              self.type))

    @property
    def has_params(self):
        return self.weight_shape is not None

    @property
    def params(self):
        if not self.has_params:
            return 0
        return int(math.prod(self.weight_shape)) + self.weight_shape[-1]


def _pool_len(size, k, stride):
    """Ceil-mode output length (a partial window at the edge counts)."""
    if size <= k:
        return 1
    return -(-(size - k) // stride) + 1


class Model(object):
    """The layer table of one configuration."""

    def __init__(self, config):
        self.config = config
        self.name = config["name"]
        self.input_shape = tuple(config["input_shape"])
        self.classes = int(config["classes"])
        self.layers = []
        shape = self.input_shape
        for i, spec in enumerate(config["layers"]):
            layer = Layer(i, spec, shape)
            self.layers.append(layer)
            shape = layer.out_shape
        if shape != (self.classes,):
            raise ValueError("%s: the table ends in %s, not %d classes"
                             % (self.name, shape, self.classes))
        self.solver = dict(config["solver"])

    @property
    def param_layers(self):
        return [l for l in self.layers if l.has_params]

    @property
    def parameters(self):
        return sum(l.params for l in self.layers)

    def zoo_specs(self):
        """The table as the program's layer specs (the zoo's dict
        format): what a configuration without a zoo source runs, and
        what a zoo source has to equal."""
        lr = self.solver["learning_rate"]
        moment = self.solver["gradient_moment"]
        specs = []
        for layer in self.layers:
            s = layer.spec
            if layer.type == "conv":
                spec = {"type": "conv_str", "n_kernels": s["filters"],
                        "kx": s["kernel"], "ky": s["kernel"],
                        "learning_rate": lr, "gradient_moment": moment}
                if s.get("stride", 1) != 1:
                    spec["sliding"] = (s["stride"], s["stride"])
                spec["padding"] = s["pad"]
            elif layer.type == "maxpool":
                spec = {"type": "max_pooling", "kx": s["kernel"],
                        "ky": s["kernel"],
                        "sliding": (s["stride"], s["stride"])}
            elif layer.type == "dropout":
                spec = {"type": "dropout", "dropout_ratio": s["ratio"]}
            else:
                spec = {"type": "softmax" if s["act"] == "softmax"
                        else "all2all_str",
                        "output_sample_shape": s["units"],
                        "learning_rate": lr, "gradient_moment": moment}
            specs.append(spec)
        return specs


def load_config(path):
    with open(path) as fin:
        return Model(json.load(fin))
