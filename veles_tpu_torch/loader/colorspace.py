"""Numpy color-space conversions for the image loaders.

Counterpart of ``veles_tpu/loader/colorspace.py``: pure numpy, following
cv2's numeric conventions, so a cv2-produced and a numpy-produced tensor
are interchangeable:

- uint8 images: channel values in [0, 255]; HSV hue is degrees/2 in
  [0, 180); YCR_CB uses the BT.601 matrix with delta 128.
- float images (expected in [0, 1]): HSV hue is degrees in [0, 360);
  YCR_CB delta is 0.5.
- GRAY uses the BT.601 luma weights (0.299 R + 0.587 G + 0.114 B) and
  comes back as a 2-D array, like cv2.

Conversions route through an RGB hub, so every (src, dst) pair in
SPACES works, GRAY -> HSV included, which cv2 has no direct code for.
"""

import numpy

__all__ = ["convert", "channels", "SPACES"]

SPACES = ("GRAY", "RGB", "BGR", "HSV", "YCR_CB")
_CHANNELS = {"GRAY": 1, "RGB": 3, "BGR": 3, "HSV": 3, "YCR_CB": 3}
_ALIASES = {"YCRCB": "YCR_CB", "GREY": "GRAY"}

# BT.601 (the cv2 forward constants); the inverse is DERIVED from the
# forward matrix rather than copied from cv2's rounded 1.403/1.773
# table, so a convert round-trip is lossless to float precision
_LUMA = numpy.array([0.299, 0.587, 0.114], numpy.float32)
_CR_SCALE, _CB_SCALE = 0.713, 0.564
_CR_TO_R = 1.0 / _CR_SCALE
_CB_TO_B = 1.0 / _CB_SCALE
_CR_TO_G = -_LUMA[0] / (_CR_SCALE * _LUMA[1])
_CB_TO_G = -_LUMA[2] / (_CB_SCALE * _LUMA[1])


def _norm_space(space):
    s = str(space).upper()
    s = _ALIASES.get(s, s)
    if s not in _CHANNELS:
        raise ValueError("unknown color space %r (choose from %s)" %
                         (space, ", ".join(SPACES)))
    return s


def channels(space):
    """Channel count of a color space."""
    return _CHANNELS[_norm_space(space)]


def convert(img, src, dst):
    """Convert ``img`` from color space ``src`` to ``dst``.

    uint8 in -> uint8 out; any float in -> float32 out.  GRAY output
    is 2-D; GRAY input may be (H, W) or (H, W, 1).
    """
    src, dst = _norm_space(src), _norm_space(dst)
    img = numpy.asarray(img)
    if src == dst:
        return img
    is_u8 = img.dtype == numpy.uint8
    rgb = _to_rgb(_canonical(img, src, is_u8), src)
    return _emit(_from_rgb(rgb, dst), dst, is_u8)


def _canonical(img, src, is_u8):
    """To float canonical form: channels in [0, 1], HSV hue in
    degrees."""
    x = img.astype(numpy.float32)
    if src == "GRAY" and x.ndim == 3:
        x = x[..., 0]
    if is_u8:
        if src == "HSV":
            x = numpy.stack([x[..., 0] * 2.0, x[..., 1] / 255.0,
                             x[..., 2] / 255.0], axis=-1)
        else:
            x = x / 255.0
    return x


def _to_rgb(x, src):
    if src == "RGB":
        return x
    if src == "BGR":
        return x[..., ::-1]
    if src == "GRAY":
        return numpy.repeat(x[..., None], 3, axis=-1)
    if src == "HSV":
        return _hsv_to_rgb(x)
    # YCR_CB
    y = x[..., 0]
    cr = x[..., 1] - 0.5
    cb = x[..., 2] - 0.5
    return numpy.stack([y + _CR_TO_R * cr,
                        y + _CR_TO_G * cr + _CB_TO_G * cb,
                        y + _CB_TO_B * cb], axis=-1)


def _from_rgb(rgb, dst):
    if dst == "RGB":
        return rgb
    if dst == "BGR":
        return rgb[..., ::-1]
    if dst == "GRAY":
        return rgb @ _LUMA
    if dst == "HSV":
        return _rgb_to_hsv(rgb)
    # YCR_CB
    y = rgb @ _LUMA
    cr = (rgb[..., 0] - y) * _CR_SCALE + 0.5
    cb = (rgb[..., 2] - y) * _CB_SCALE + 0.5
    return numpy.stack([y, cr, cb], axis=-1)


def _emit(x, dst, is_u8):
    """From float canonical form back to the output encoding."""
    if not is_u8:
        if dst != "HSV":
            x = numpy.clip(x, 0.0, 1.0)
        return numpy.ascontiguousarray(x.astype(numpy.float32))
    if dst == "HSV":
        x = numpy.stack([x[..., 0] / 2.0, x[..., 1] * 255.0,
                         x[..., 2] * 255.0], axis=-1)
    else:
        x = x * 255.0
    return numpy.ascontiguousarray(
        numpy.clip(numpy.round(x), 0, 255).astype(numpy.uint8))


def _rgb_to_hsv(rgb):
    """RGB [0,1] -> (H degrees [0,360), S [0,1], V [0,1])."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = numpy.max(rgb, axis=-1)
    c = v - numpy.min(rgb, axis=-1)
    safe = numpy.where(c > 0, c, 1.0)
    h = numpy.where(
        v == r, ((g - b) / safe) % 6.0,
        numpy.where(v == g, (b - r) / safe + 2.0,
                    (r - g) / safe + 4.0))
    h = numpy.where(c > 0, h * 60.0, 0.0)
    s = numpy.where(v > 0, c / numpy.where(v > 0, v, 1.0), 0.0)
    return numpy.stack([h, s, v], axis=-1)


def _hsv_to_rgb(hsv):
    """(H degrees, S [0,1], V [0,1]) -> RGB [0,1]."""
    h6 = (hsv[..., 0] / 60.0) % 6.0
    s, v = hsv[..., 1], hsv[..., 2]
    i = numpy.floor(h6)
    f = h6 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    i = i.astype(numpy.int32)
    r = numpy.choose(i, [v, q, p, p, t, v])
    g = numpy.choose(i, [t, v, v, q, p, p])
    b = numpy.choose(i, [p, p, t, v, v, q])
    return numpy.stack([r, g, b], axis=-1)
