"""The port's RESTful unit (veles_tpu_torch/restful_api.py, with
``AOTEngine.from_workflow``) against the JAX package's
(veles_tpu/restful_api.py), both serving the same trained weights over
HTTP on the CPU.

- every validation sample posted to both: equal labels, probabilities
  within 1e-5 (the serve tier's limit, tests/test_torch_serve_tier.py);
- ``infer()`` without the background server, and ``requests_served``;
- a stopped batcher answers 503 with ``{"error", "retry_after"}`` and a
  ``Retry-After`` header in both packages;
- the answers do not move when the workflow trains on: the engine
  serves the weights it took at ``initialize``;
- with no card and no ``-d cpu``, a unit on a workflow with no device
  raises ``no CUDA device`` before a socket opens.
"""

import json
import urllib.error
import urllib.request

import numpy
import pytest
import torch

import veles_tpu.compiler as jax_compiler
from veles_tpu.restful_api import RESTfulAPI as JaxRESTfulAPI
from veles_tpu_torch.convert import adopt_workflow_state
from veles_tpu_torch.restful_api import RESTfulAPI

from test_torch_workflow import blobs, build_jax, build_torch

#: the serve tier's probability limit between the packages
LIMIT = 1e-5


def _post(port, payload, path="/api"):
    req = urllib.request.Request(
        "http://127.0.0.1:%d%s" % (port, path),
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


@pytest.fixture(scope="module")
def pair():
    """A JAX workflow trained 2 epochs and a port workflow holding its
    weights, both on the CPU, and the validation samples."""
    arrays = blobs()
    jsw = build_jax(arrays, epochs=2)
    jsw.run()
    state = [{k: None if v is None else numpy.asarray(v)
              for k, v in entry.items()}
             for entry in jax_compiler.extract_state(jsw)]
    tsw = build_torch(arrays, epochs=4)
    adopt_workflow_state(tsw, state)
    return jsw, tsw, arrays[0]


def test_http_answers_match_jax(pair):
    jsw, tsw, valid_x = pair
    apis = [JaxRESTfulAPI(jsw), RESTfulAPI(tsw)]
    for api in apis:
        api.initialize()
        api.start_background()
    try:
        got, want = [], []
        for x in valid_x:
            want.append(_post(apis[0].port, {"input": x.tolist()}))
            got.append(_post(apis[1].port, {"input": x.tolist()}))
        assert [a["result"] for a in got] == [a["result"] for a in want]
        numpy.testing.assert_allclose(
            [a["probabilities"] for a in got],
            [a["probabilities"] for a in want], rtol=0, atol=LIMIT)
        probs = numpy.array([a["probabilities"][0] for a in got])
        assert [a["result"] for a in got] == probs.argmax(1).tolist()
        assert apis[1].requests_served == apis[0].requests_served == \
            len(valid_x)
        # a batch payload answers its rows as the engine does
        batch = _post(apis[1].port, {"input": valid_x[:5].tolist()})
        engine = apis[1].engine.infer(valid_x[:5])
        numpy.testing.assert_array_equal(
            numpy.array(batch["probabilities"], numpy.float32), engine)
        assert apis[1].requests_served == len(valid_x) + 5
    finally:
        for api in apis:
            api.stop()


def test_infer_without_server_and_after_training_on(pair):
    """``infer()`` through the engine alone, counted; the answers stay
    put while the workflow trains on."""
    jsw, tsw, valid_x = pair
    api = RESTfulAPI(tsw)
    api.initialize()
    try:
        before = api.infer(valid_x)
        assert api.requests_served == len(valid_x)
        single = api.infer(valid_x[0])
        assert single["result"] == before["result"][0]
        assert api.requests_served == len(valid_x) + 1
        jax_api = JaxRESTfulAPI(jsw)
        jax_api.initialize()
        want = jax_api.infer(valid_x)
        assert before["result"] == want["result"]
        numpy.testing.assert_allclose(before["probabilities"],
                                      want["probabilities"], atol=LIMIT)
        served = []
        for fwd in tsw.forwards:
            fwd.weights.map_read()
            served.append(fwd.weights.mem.copy())
        tsw.run()  # trains on, 4 epochs
        moved = 0.0
        for fwd, weights in zip(tsw.forwards, served):
            fwd.weights.map_read()
            moved = max(moved, float(numpy.abs(fwd.weights.mem -
                                               weights).max()))
        assert moved > 0, "the workflow did not train on"
        after = api.infer(valid_x)
        assert after == before
        # a unit made now serves the new weights
        fresh = RESTfulAPI(tsw)
        fresh.initialize()
        assert fresh.infer(valid_x)["probabilities"] != \
            before["probabilities"]
        fresh.stop()
        jax_api.stop()
    finally:
        api.stop()


def test_overload_answers_503_like_jax(pair):
    jsw, tsw, valid_x = pair
    bodies = []
    for api in (JaxRESTfulAPI(jsw), RESTfulAPI(tsw)):
        api.initialize()
        api.start_background()
        try:
            api._service_.batcher.stop()
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(api.port, {"input": valid_x[0].tolist()})
            assert err.value.code == 503
            assert float(err.value.headers["Retry-After"]) > 0
            bodies.append(json.loads(err.value.read()))
        finally:
            api.stop()
    assert set(bodies[0]) == set(bodies[1]) == {"error", "retry_after"}
    assert bodies[1]["error"] == bodies[0]["error"]


def test_without_a_card_the_unit_asks_for_it():
    """A workflow never initialized has no device: the unit takes
    ``Device()``, the card, and raises before a socket opens."""
    if torch.cuda.is_available():
        pytest.skip("with a card, no device means the card")
    tsw = build_torch(blobs(), initialize=False)
    api = RESTfulAPI(tsw)
    with pytest.raises(RuntimeError) as err:
        api.initialize()
    assert "no CUDA device" in str(err.value)
    assert api._service_ is None
