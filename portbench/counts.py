"""The yardstick's operation and byte counts, frozen with the benchmark.

Every count is worked out from a configuration's layer table
(:mod:`portbench.model`), never from the program, so a change to the
program cannot move it.  Operations are products only: 2·M·N·K for each
matrix product and convolution (a multiply and an add), no
elementwise work.

- ``forward_flops``: the products of one image's forward pass.
- ``train_flops``: one image's share of a train step: the forward, the
  weight gradient (dW) of every layer with parameters, and the input
  gradient (dX) of every such layer that has a layer with parameters
  before it.  Each is the layer's forward product count again.
- ``conv_wgrad_bound_s``: the least time the card could take for the
  ``conv_wgrad`` kernel's work in one train step: for each conv layer
  the larger of its dW products over the peak and its bytes (x, y and
  dy read once; err, grad_w and grad_b written once, f32) over the
  memory rate.  The work is counted once, not as the several bf16
  products an implementation may spend on it.
- ``max_pool_bwd_bound_s``: the same for the pool backward: x, y, dy
  read and dx written once, f32; no products.
- ``matmul_int8_bound_s``: one dispatch's int8 products at a rung, each
  quantized layer as an (M, K) x (K, N) product (a conv as its im2col
  form, M = rows x output pixels, K = kernel taps x input channels):
  the larger of 2·M·N·K over the int8 peak and its bytes (the int8
  operands read once, the f32 output written once, the f32 scale and
  bias read once) over the memory rate.
"""

import json
import math
import os

__all__ = ["PEAKS_PATH", "load_peaks", "layer_flops", "forward_flops",
           "train_flops", "conv_wgrad_bound_s", "max_pool_bwd_bound_s",
           "int8_products", "matmul_int8_bound_s"]

PEAKS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "peaks.json")
F32 = 4


def load_peaks(path=PEAKS_PATH):
    with open(path) as fin:
        return json.load(fin)


def layer_flops(layer):
    """Forward product FLOPs of one layer for one image."""
    if layer.type == "conv":
        oh, ow, co = layer.out_shape
        return 2 * oh * ow * co * layer.fan_in
    if layer.type == "fc":
        return 2 * layer.fan_in * layer.out_shape[0]
    return 0


def forward_flops(model):
    return sum(layer_flops(l) for l in model.layers)


def train_flops(model):
    total = 0
    seen_params = False
    for layer in model.layers:
        flops = layer_flops(layer)
        total += 2 * flops  # forward and dW
        if seen_params:
            total += flops  # dX
        seen_params = seen_params or layer.has_params
    return total


def _numel(shape):
    return int(math.prod(shape))


def conv_wgrad_bound_s(model, batch, peaks):
    """Seconds: the sum over conv layers of one step's bound."""
    rate = peaks["ops_per_s"]["bfloat16"]
    bw = peaks["hbm_bytes_per_s"]
    total = 0.0
    for layer in model.layers:
        if layer.type != "conv":
            continue
        x = batch * _numel(layer.in_shape)
        y = batch * _numel(layer.out_shape)
        w = _numel(layer.weight_shape) + layer.weight_shape[-1]
        nbytes = F32 * (x + 3 * y + w)
        total += max(batch * layer_flops(layer) / rate, nbytes / bw)
    return total


def max_pool_bwd_bound_s(model, batch, peaks):
    bw = peaks["hbm_bytes_per_s"]
    total = 0.0
    for layer in model.layers:
        if layer.type != "maxpool":
            continue
        x = batch * _numel(layer.in_shape)
        y = batch * _numel(layer.out_shape)
        total += F32 * 2 * (x + y) / bw
    return total


def int8_products(model, rows):
    """(M, N, K) of each quantized layer's product at ``rows`` rows."""
    out = []
    for layer in model.layers:
        if layer.type == "conv":
            oh, ow, co = layer.out_shape
            out.append((rows * oh * ow, co, layer.fan_in))
        elif layer.type == "fc":
            out.append((rows, layer.out_shape[0], layer.fan_in))
    return out


def matmul_int8_bound_s(model, rows, peaks):
    rate = peaks["ops_per_s"]["int8"]
    bw = peaks["hbm_bytes_per_s"]
    total = 0.0
    for m, n, k in int8_products(model, rows):
        nbytes = m * k + k * n + F32 * (m * n + 2 * n)
        total += max(2.0 * m * n * k / rate, nbytes / bw)
    return total
