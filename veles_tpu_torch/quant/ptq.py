"""Post-training quantization pass: calibrate, scale, round, clip.

Counterpart of ``veles_tpu/quant/ptq.py``, with the same scheme:

- **Weights**: per-output-channel symmetric scales, ``s_w[c] =
  max|W[..., c]| / 127`` (an all-zero channel gets scale 1.0), and
  ``W_q = clip(round(W / s_w), -127, 127)`` as int8.
- **Activations**: one symmetric scale per layer input, calibrated on a
  sample stream run through the f32 forward: ``mode="minmax"`` takes
  the observed ``max|x|``, ``mode="percentile"`` (the default) the
  ``percentile``-th percentile of ``|x|``, clipping the outlier tail.

Biases stay f32.  The calibration record is written as JSON into
:func:`calibration_dir` (``VELES_QUANT_CALIB`` overrides it).  The
statistics are taken on the host with numpy, as on the JAX side, so
both packages solve their scales the same way.
"""

import json
import logging
import os

import numpy
import torch

__all__ = ["CalibrationResult", "calibrate_activations",
           "calibration_dir", "quantize_model_spec", "quantize_tensor",
           "quantize_weights", "QMAX"]

logger = logging.getLogger("veles_tpu_torch.quant")

#: symmetric int8 grid: [-127, 127]; -128 is unused so the grid is
#: symmetric around zero
QMAX = 127


def calibration_dir():
    """``$VELES_QUANT_CALIB``, else ``quant_calib`` under the package's
    build directory — resolved per call so tests can redirect it."""
    env = os.environ.get("VELES_QUANT_CALIB", "")
    if env:
        return env
    from veles_tpu_torch.ops.common import BUILD_DIR
    return os.path.join(BUILD_DIR, "quant_calib")


def quantize_tensor(x, scale):
    """``clip(round(x / scale), -127, 127)`` as int8, numpy in and out;
    ``numpy.rint`` rounds half to even, as ``torch.round`` does."""
    x = numpy.asarray(x, numpy.float32)
    q = numpy.rint(x / numpy.asarray(scale, numpy.float32))
    return numpy.clip(q, -QMAX, QMAX).astype(numpy.int8)


def quantize_weights(weights, granularity="channel"):
    """(W_q int8, scales f32 (Cout,)): the last axis is the output
    channel for both the all2all (fan_in, fan_out) and the conv HWIO
    layouts.  ``granularity="tensor"`` broadcasts one scale."""
    w = numpy.asarray(weights, numpy.float32)
    cout = w.shape[-1]
    flat = numpy.abs(w.reshape(-1, cout))
    if granularity == "channel":
        amax = flat.max(axis=0)
    elif granularity == "tensor":
        amax = numpy.full((cout,), flat.max() if flat.size else 0.0,
                          numpy.float32)
    else:
        raise ValueError("granularity must be 'channel' or 'tensor', "
                         "got %r" % (granularity,))
    scales = numpy.where(amax > 0, amax / QMAX, 1.0).astype(
        numpy.float32)
    return quantize_tensor(w, scales), scales


class CalibrationResult(object):
    """Per-layer activation calibration: what the quantizer consumes
    and the sidecar JSON records."""

    __slots__ = ("mode", "percentile", "samples", "layers")

    def __init__(self, mode, percentile, samples, layers):
        self.mode = mode
        self.percentile = percentile
        self.samples = int(samples)
        self.layers = layers  # {layer index: {"act_scale", "amax",
        #                       "observed_max", "clip_fraction", "cls"}}

    @property
    def clip_fraction(self):
        """Mean clipped fraction over the calibrated layers."""
        if not self.layers:
            return 0.0
        return float(numpy.mean(
            [e["clip_fraction"] for e in self.layers.values()]))

    def to_dict(self):
        return {"mode": self.mode, "percentile": self.percentile,
                "samples": self.samples,
                "clip_fraction": round(self.clip_fraction, 6),
                "layers": {str(i): dict(e)
                           for i, e in sorted(self.layers.items())}}

    def save(self, path=None):
        """Write the sidecar JSON record; returns the path."""
        if path is None:
            digest = "%08x" % (hash(tuple(sorted(
                (i, round(e["act_scale"], 9))
                for i, e in self.layers.items()))) & 0xffffffff)
            path = os.path.join(calibration_dir(),
                                "calib_%s.json" % digest)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as fout:
            json.dump(self.to_dict(), fout, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path


def _quantizable(plan, entry):
    """True for the layers the int8 path covers: all2all and conv
    forwards with weights."""
    if entry.get("weights") is None:
        return False
    from veles_tpu_torch.models.all2all import All2All
    from veles_tpu_torch.models.conv import Conv
    return issubclass(plan.forward_cls, (All2All, Conv))


def calibrate_activations(plans, params, samples, mode="percentile",
                          percentile=99.9, device=None):
    """Run ``samples`` through the f32 forward on ``device`` (default
    ``Device()``, the card), recording each quantizable layer's input
    range; returns a :class:`CalibrationResult`.  ``params`` are host
    arrays or tensors in the JAX layouts."""
    from veles_tpu_torch.quant.forward import f32_layer_apply, walk_forward

    if mode not in ("minmax", "percentile"):
        raise ValueError("mode must be 'minmax' or 'percentile', got %r"
                         % (mode,))
    x = numpy.asarray(samples, numpy.float32)
    if x.ndim and x.shape[0] == 0:
        raise ValueError("calibration needs a non-empty sample stream")
    if device is None:
        from veles_tpu_torch.backends import Device
        device = Device()
    layers = {}

    def record_then_apply(i, plan, entry, h):
        if _quantizable(plan, entry):
            vals = numpy.abs(h.detach().to("cpu", torch.float32)
                             .numpy()).ravel()
            full = float(vals.max()) if vals.size else 0.0
            if mode == "percentile" and vals.size:
                amax = float(numpy.percentile(vals, percentile))
            else:
                amax = full
            if amax <= 0:
                amax = 1.0  # degenerate stream: identity-safe scale
            clipped = float(numpy.mean(vals > amax)) if vals.size \
                else 0.0
            layers[i] = {
                "act_scale": amax / QMAX, "amax": amax,
                "observed_max": full,
                "clip_fraction": round(clipped, 6),
                "cls": plan.forward_cls.__name__}
        fentry = {key: None if entry.get(key) is None
                  else device.put(entry[key])
                  for key in ("weights", "bias")}
        return f32_layer_apply(plan, fentry, h)

    with torch.inference_mode():
        walk_forward(plans, params, device.put(x), record_then_apply)
    return CalibrationResult(mode, percentile, x.shape[0], layers)


def quantize_model_spec(plans, params, samples=None, calibration=None,
                        mode="percentile", percentile=99.9,
                        weight_granularity="channel",
                        save_report=True, device=None):
    """f32 (plans, params) -> the quantized params list; the plans are
    unchanged.  Quantizable entries come back as ``{"weights": int8,
    "weights_scale": f32 (Cout,), "act_scale": f32 scalar, "bias":
    f32}`` numpy arrays, the others as ``{"weights", "bias"}``.

    Pass ``samples`` (calibrated on ``device``) or a precomputed
    ``calibration``; returns ``(qparams, calibration)``."""
    if calibration is None:
        if samples is None:
            raise ValueError("need samples or a CalibrationResult")
        calibration = calibrate_activations(
            plans, params, samples, mode=mode, percentile=percentile,
            device=device)
    qparams = []
    for i, (plan, entry) in enumerate(zip(plans, params)):
        if not _quantizable(plan, entry) or i not in calibration.layers:
            qparams.append({
                "weights": None if entry.get("weights") is None
                else _host(entry["weights"]),
                "bias": None if entry.get("bias") is None
                else _host(entry["bias"])})
            continue
        w_q, scales = quantize_weights(_host(entry["weights"]),
                                       granularity=weight_granularity)
        qparams.append({
            "weights": w_q,
            "weights_scale": scales,
            "act_scale": numpy.asarray(
                calibration.layers[i]["act_scale"], numpy.float32),
            "bias": None if entry.get("bias") is None
            else _host(entry["bias"])})
    if save_report:
        try:
            path = calibration.save()
            logger.info("quantized %d/%d layers (%s, clip %.4f%%); "
                        "calibration record: %s",
                        len(calibration.layers), len(plans),
                        weight_granularity,
                        100.0 * calibration.clip_fraction, path)
        except OSError as exc:  # a read-only directory must not fail PTQ
            logger.warning("calibration record not written: %s", exc)
    return qparams, calibration


def _host(leaf):
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu().numpy()
    return numpy.asarray(leaf, numpy.float32)
