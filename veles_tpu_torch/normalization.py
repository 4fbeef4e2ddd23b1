"""Dataset normalizers.

Counterpart of ``veles_tpu/normalization.py``, numpy only, kept as a
copy so the port imports nothing of the JAX package: a keyed registry of
normalizers with the analyze -> coefficients -> normalize / denormalize
lifecycle and picklable state (``none``, ``linear``, ``range_linear``,
``mean_disp``, ``exp``, ``pointwise``, ``external_mean``,
``internal_mean``).

Coefficients are numpy (host side): normalization is a data-preparation
step.  ``MeanDispersionNormalizer.mean`` / ``rdisp`` are float64; the
per-minibatch device application (``service_units.MeanDispNormalizer``
-> ``ops.normalize.mean_disp_normalize``) casts them to float32 first,
as the host ``normalize`` of float32 data does.
"""

import numpy

__all__ = [
    "NormalizerRegistry", "NormalizerBase", "StatelessNormalizer",
    "NoneNormalizer", "LinearNormalizer", "RangeLinearNormalizer",
    "MeanDispersionNormalizer", "ExponentNormalizer", "PointwiseNormalizer",
    "ExternalMeanNormalizer", "InternalMeanNormalizer",
]


class NormalizerRegistry(type):
    """Metaclass registry mapping ``MAPPING`` names to classes
    (reference: normalization.py:110)."""

    normalizers = {}

    def __init__(cls, name, bases, namespace):
        super(NormalizerRegistry, cls).__init__(name, bases, namespace)
        mapping = namespace.get("MAPPING")
        if mapping:
            NormalizerRegistry.normalizers[mapping] = cls

    @staticmethod
    def get(name, **kwargs):
        try:
            factory = NormalizerRegistry.normalizers[name]
        except KeyError:
            raise ValueError(
                "Unknown normalization type %r (known: %s)" % (
                    name, sorted(NormalizerRegistry.normalizers)))
        return factory(**kwargs)


class NormalizerBase(object, metaclass=NormalizerRegistry):
    """analyze() accumulates dataset statistics; normalize()/denormalize()
    apply them in place-compatible fashion (returns the array)."""

    MAPPING = None

    def __init__(self, **kwargs):
        self._initialized = False
        self.kwargs = kwargs

    @property
    def initialized(self):
        return self._initialized

    def analyze(self, data):
        """Accumulate statistics from a chunk of the dataset."""
        self._analyze(numpy.asarray(data))
        self._initialized = True

    def _analyze(self, data):
        raise NotImplementedError

    def normalize(self, data):
        if not self._initialized:
            raise RuntimeError(
                "%s.normalize() before analyze()" % type(self).__name__)
        return self._normalize(data)

    def denormalize(self, data):
        if not self._initialized:
            raise RuntimeError(
                "%s.denormalize() before analyze()" % type(self).__name__)
        return self._denormalize(data)

    def analyze_and_normalize(self, data):
        self.analyze(data)
        return self.normalize(data)

    def _normalize(self, data):
        raise NotImplementedError

    def _denormalize(self, data):
        raise NotImplementedError

    def __getstate__(self):
        return self.__dict__.copy()

    def __setstate__(self, state):
        self.__dict__.update(state)


class StatelessNormalizer(NormalizerBase):
    """Normalizers that need no dataset statistics."""

    def analyze(self, data):
        self._initialized = True

    def _analyze(self, data):
        pass


class NoneNormalizer(StatelessNormalizer):
    """Identity (reference: normalization.py:496)."""

    MAPPING = "none"

    def _normalize(self, data):
        return data

    def _denormalize(self, data):
        return data


class _IntervalMixin(object):
    """Target interval handling shared by the linear family
    (reference: normalization.py:322)."""

    def _init_interval(self, kwargs):
        self.interval = tuple(kwargs.get("interval", (-1.0, 1.0)))
        if len(self.interval) != 2:
            raise ValueError("interval must be (min, max)")


class LinearNormalizer(StatelessNormalizer, _IntervalMixin):
    """Scale each *sample* into the target interval using its own
    min/max (stateless; reference: normalization.py:347)."""

    MAPPING = "linear"

    def __init__(self, **kwargs):
        super(LinearNormalizer, self).__init__(**kwargs)
        self._init_interval(kwargs)

    def _normalize(self, data):
        data = numpy.asarray(data, numpy.float64) \
            if not numpy.issubdtype(numpy.asarray(data).dtype,
                                    numpy.floating) else numpy.asarray(data)
        flat = data.reshape(len(data), -1)
        dmin = flat.min(axis=1, keepdims=True)
        dmax = flat.max(axis=1, keepdims=True)
        span = dmax - dmin
        span[span == 0] = 1
        lo, hi = self.interval
        flat *= (hi - lo) / span
        shift = dmin * (hi - lo) / span - lo
        flat -= shift
        return data

    def _denormalize(self, data):
        raise NotImplementedError(
            "linear is per-sample lossy; denormalize is undefined")


class RangeLinearNormalizer(NormalizerBase, _IntervalMixin):
    """Scale using the GLOBAL dataset min/max gathered by analyze()
    (reference: normalization.py:398)."""

    MAPPING = "range_linear"

    def __init__(self, **kwargs):
        super(RangeLinearNormalizer, self).__init__(**kwargs)
        self._init_interval(kwargs)
        self.min = None
        self.max = None

    def _analyze(self, data):
        dmin, dmax = float(data.min()), float(data.max())
        self.min = dmin if self.min is None else min(self.min, dmin)
        self.max = dmax if self.max is None else max(self.max, dmax)

    def _scale(self):
        span = self.max - self.min
        if span == 0:
            span = 1.0
        lo, hi = self.interval
        return (hi - lo) / span

    def _normalize(self, data):
        lo, _hi = self.interval
        data -= self.min
        data *= self._scale()
        data += lo
        return data

    def _denormalize(self, data):
        lo, _hi = self.interval
        data -= lo
        data /= self._scale()
        data += self.min
        return data


class MeanDispersionNormalizer(NormalizerBase):
    """(x - mean) / (max - min), computed feature-wise over the dataset
    (reference: normalization.py:284).  Exposes ``mean`` and ``rdisp``
    for the on-device ops.normalize kernel."""

    MAPPING = "mean_disp"

    def __init__(self, **kwargs):
        super(MeanDispersionNormalizer, self).__init__(**kwargs)
        self._sum = None
        self._count = 0
        self._min = None
        self._max = None

    def _analyze(self, data):
        flat = data.reshape(len(data), -1).astype(numpy.float64)
        s = flat.sum(axis=0)
        mn = flat.min(axis=0)
        mx = flat.max(axis=0)
        if self._sum is None:
            self._sum, self._min, self._max = s, mn, mx
        else:
            self._sum += s
            numpy.minimum(self._min, mn, out=self._min)
            numpy.maximum(self._max, mx, out=self._max)
        self._count += len(flat)

    @property
    def mean(self):
        return self._sum / self._count

    @property
    def disp(self):
        return self._max - self._min

    @property
    def rdisp(self):
        disp = self.disp.copy()
        disp[disp == 0] = 1
        return 1.0 / disp

    def _normalize(self, data):
        flat = data.reshape(len(data), -1)
        flat -= self.mean.astype(flat.dtype)
        flat *= self.rdisp.astype(flat.dtype)
        return data

    def _denormalize(self, data):
        flat = data.reshape(len(data), -1)
        flat /= self.rdisp.astype(flat.dtype)
        flat += self.mean.astype(flat.dtype)
        return data


class ExponentNormalizer(StatelessNormalizer):
    """Stable softmax-style exponent normalization per sample
    (reference: normalization.py:467)."""

    MAPPING = "exp"

    def _normalize(self, data):
        flat = data.reshape(len(data), -1)
        flat -= flat.max(axis=1, keepdims=True)
        numpy.exp(flat, out=flat)
        flat /= flat.sum(axis=1, keepdims=True)
        return data

    def _denormalize(self, data):
        flat = data.reshape(len(data), -1)
        numpy.log(flat, out=flat)
        return data


class PointwiseNormalizer(NormalizerBase):
    """Per-feature linear map into [-1, 1] computed from feature-wise
    min/max (reference: normalization.py:511)."""

    MAPPING = "pointwise"

    def __init__(self, **kwargs):
        super(PointwiseNormalizer, self).__init__(**kwargs)
        self._min = None
        self._max = None

    def _analyze(self, data):
        flat = data.reshape(len(data), -1).astype(numpy.float64)
        mn = flat.min(axis=0)
        mx = flat.max(axis=0)
        if self._min is None:
            self._min, self._max = mn, mx
        else:
            numpy.minimum(self._min, mn, out=self._min)
            numpy.maximum(self._max, mx, out=self._max)

    @property
    def _mul_add(self):
        disp = self._max - self._min
        disp[disp == 0] = 1
        mul = 2.0 / disp
        add = -1.0 - self._min * mul
        return mul, add

    def _normalize(self, data):
        mul, add = self._mul_add
        flat = data.reshape(len(data), -1)
        flat *= mul.astype(flat.dtype)
        flat += add.astype(flat.dtype)
        return data

    def _denormalize(self, data):
        mul, add = self._mul_add
        flat = data.reshape(len(data), -1)
        flat -= add.astype(flat.dtype)
        flat /= mul.astype(flat.dtype)
        return data


class ExternalMeanNormalizer(StatelessNormalizer):
    """Subtract a user-supplied mean sample (reference:
    normalization.py:593).  kwargs: mean_source (array or .npy path),
    scale (optional divisor)."""

    MAPPING = "external_mean"

    def __init__(self, **kwargs):
        super(ExternalMeanNormalizer, self).__init__(**kwargs)
        source = kwargs.get("mean_source")
        if source is None:
            raise ValueError("external_mean requires mean_source")
        if isinstance(source, str):
            source = numpy.load(source)
        self.mean = numpy.asarray(source)
        self.scale = kwargs.get("scale", 1.0)

    def _normalize(self, data):
        flat = data.reshape(len(data), -1)
        flat -= self.mean.ravel().astype(flat.dtype)
        if self.scale != 1.0:
            flat /= self.scale
        return data

    def _denormalize(self, data):
        flat = data.reshape(len(data), -1)
        if self.scale != 1.0:
            flat *= self.scale
        flat += self.mean.ravel().astype(flat.dtype)
        return data


class InternalMeanNormalizer(NormalizerBase):
    """Subtract the dataset mean computed by analyze()
    (reference: normalization.py:636)."""

    MAPPING = "internal_mean"

    def __init__(self, **kwargs):
        super(InternalMeanNormalizer, self).__init__(**kwargs)
        self._sum = None
        self._count = 0

    def _analyze(self, data):
        flat = data.reshape(len(data), -1).astype(numpy.float64)
        s = flat.sum(axis=0)
        if self._sum is None:
            self._sum = s
        else:
            self._sum += s
        self._count += len(flat)

    @property
    def mean(self):
        return self._sum / self._count

    def _normalize(self, data):
        flat = data.reshape(len(data), -1)
        flat -= self.mean.astype(flat.dtype)
        return data

    def _denormalize(self, data):
        flat = data.reshape(len(data), -1)
        flat += self.mean.astype(flat.dtype)
        return data
