"""Workflow package export for the native inference runtime.

Counterpart of ``veles_tpu/package.py``, with the same format, so one
model exports to the same bytes from either package:

- container is an uncompressed POSIX tar (the C++ runtime embeds a
  ~100-line ustar reader instead of vendoring zip/libarchive as the
  reference did via empty submodules);
- ``contents.json`` lists the INFERENCE chain (forward units only) in
  execution order, each with its stable class UUID (the C++
  UnitFactory key, reference unit_factory.cc:1-65), properties, and
  array file names;
- arrays are standard .npy; ``precision="float16"`` stores fp16 that the
  native loader widens to f32 on load (reference
  numpy_array_loader.cc fp16 path);
- dropout units are omitted (inverted dropout is identity at
  inference).
"""

import io
import json
import tarfile

import numpy

__all__ = ["export_workflow", "UNIT_UUIDS"]

#: stable class-name -> UUID registry mirrored in native/src/units.cc
UNIT_UUIDS = {
    "All2All":          "5a51b268-0001-4000-8000-76656c6573aa",
    "All2AllTanh":      "5a51b268-0002-4000-8000-76656c6573aa",
    "All2AllRELU":      "5a51b268-0003-4000-8000-76656c6573aa",
    "All2AllStrictRELU": "5a51b268-0004-4000-8000-76656c6573aa",
    "All2AllSigmoid":   "5a51b268-0005-4000-8000-76656c6573aa",
    "All2AllSoftmax":   "5a51b268-0006-4000-8000-76656c6573aa",
    "Conv":             "5a51b268-0011-4000-8000-76656c6573aa",
    "ConvTanh":         "5a51b268-0012-4000-8000-76656c6573aa",
    "ConvRELU":         "5a51b268-0013-4000-8000-76656c6573aa",
    "ConvStrictRELU":   "5a51b268-0014-4000-8000-76656c6573aa",
    "ConvSigmoid":      "5a51b268-0015-4000-8000-76656c6573aa",
    "MaxPooling":       "5a51b268-0021-4000-8000-76656c6573aa",
    "AvgPooling":       "5a51b268-0022-4000-8000-76656c6573aa",
    "MaxAbsPooling":    "5a51b268-0023-4000-8000-76656c6573aa",
    "ForwardTanh":      "5a51b268-0031-4000-8000-76656c6573aa",
    "ForwardRELU":      "5a51b268-0032-4000-8000-76656c6573aa",
    "ForwardStrictRELU": "5a51b268-0033-4000-8000-76656c6573aa",
    "ForwardSigmoid":   "5a51b268-0034-4000-8000-76656c6573aa",
    "InputJoiner":      "5a51b268-0041-4000-8000-76656c6573aa",
}


def _npy_bytes(arr, precision):
    if precision == "float16":
        arr = arr.astype(numpy.float16)
    else:
        arr = arr.astype(numpy.float32)
    buf = io.BytesIO()
    numpy.save(buf, arr)
    return buf.getvalue()


def _unit_properties(fwd):
    props = {"include_bias": bool(getattr(fwd, "include_bias", False))}
    for name in ("kx", "ky", "n_kernels", "sliding", "padding",
                 "output_sample_shape", "factor"):
        value = getattr(fwd, name, None)
        if value is not None:
            props[name] = list(value) if isinstance(value, tuple) else value
    return props


def _resolve_inputs(fwd, producer_by_array, loader):
    """Producer names for a unit, matched by Array object identity.

    Multi-input units expose ``inputs`` (a list of Arrays, e.g.
    InputJoiner); everything else exposes ``input``."""
    arrays = getattr(fwd, "inputs", None)
    if not arrays:
        arrays = [getattr(fwd, "input", None)]
    names = []
    for arr in arrays:
        if arr is None:
            continue
        key = id(arr)
        if key in producer_by_array:
            names.append(producer_by_array[key])
        elif loader is not None and arr is loader.minibatch_data:
            names.append("__input__")
        else:
            raise ValueError(
                "cannot resolve the producer of %s.input; the source "
                "must be another exported unit's output or the "
                "loader's minibatch_data" % type(fwd).__name__)
    return names


def export_workflow(workflow, path, precision="float32", units=None):
    """Write the inference package; returns the path.

    ``units``: explicit unit list for non-linear graphs (defaults to
    ``workflow.forwards``).  Links are recorded per unit (format 2) so
    the native runtime rebuilds the general DAG (reference
    workflow_loader.cc:73-120)."""
    from veles_tpu_torch.models.dropout import DropoutForward

    loader = getattr(workflow, "loader", None)
    candidates = list(units if units is not None else workflow.forwards)
    forwards = [f for f in candidates
                if not isinstance(f, DropoutForward)]
    # outputs of dropped dropout units: consumers of these fall back to
    # the dropout's own producer chain (identity at inference)
    dropped_outputs = {
        id(f.output) for f in candidates
        if isinstance(f, DropoutForward) and f.output is not None}
    out_units = []
    files = {}
    counter = 0
    producer_by_array = {}
    names = []
    for i, fwd in enumerate(forwards):
        cls_name = type(fwd).__name__
        uuid = UNIT_UUIDS.get(cls_name)
        if uuid is None:
            raise ValueError(
                "%s has no stable UUID; extend UNIT_UUIDS + the native "
                "factory" % cls_name)
        name = "u%03d_%s" % (i, cls_name)
        names.append(name)
        arrays = {}
        for aname in ("weights", "bias"):
            arr = getattr(fwd, aname, None)
            if arr is not None and arr:
                arr.map_read()
                fname = "%04d_%s.npy" % (counter, aname)
                files[fname] = _npy_bytes(arr.mem, precision)
                arrays[aname] = fname
                counter += 1
        out_units.append({
            "uuid": uuid, "class": cls_name, "name": name,
            "properties": _unit_properties(fwd),
            "arrays": arrays,
        })
        output = getattr(fwd, "output", None)
        if output is not None:
            producer_by_array[id(output)] = name

    # link pass (dropout units were dropped: look through them by
    # resolving against the kept producers only)
    for fwd, unit_json in zip(forwards, out_units):
        prev_index = out_units.index(unit_json) - 1
        try:
            unit_json["inputs"] = _resolve_inputs(
                fwd, producer_by_array, loader)
        except ValueError:
            # a dropped dropout sat between this unit and its real
            # producer: fall back to the previous kept unit
            if prev_index < 0:
                unit_json["inputs"] = ["__input__"]
            else:
                unit_json["inputs"] = [names[prev_index]]

    units = out_units
    input_shape = (list(loader.minibatch_data.shape[1:])
                   if loader is not None and loader.minibatch_data
                   else None)
    contents = {
        "format": 2,
        "workflow": type(workflow).__name__,
        "checksum": workflow.checksum,
        "precision": precision,
        "input_shape": input_shape,
        "units": units,
    }
    files["contents.json"] = json.dumps(
        contents, indent=1, sort_keys=True).encode()

    with tarfile.open(path, "w") as tar:
        for name in sorted(files):
            data = files[name]
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    return path
