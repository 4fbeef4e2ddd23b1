"""The port's observability singletons, kept to one test each.

Import the fixture into a test module (``from tests.torch_observe
import port_observe_isolated  # noqa: F401``): it is autouse there.
The port's flight recorder dumps into the test's tmp directory instead
of the working directory, and the process-wide tail-exemplar ring,
series ring and alert manager are cleared after each test, as
tests/conftest.py does for the JAX package's.  A chaos plan left
installed in the port is removed.
"""

import pytest


@pytest.fixture(autouse=True)
def port_observe_isolated(tmp_path, monkeypatch):
    from veles_tpu_torch import chaos
    from veles_tpu_torch.observe.alerts import alerts
    from veles_tpu_torch.observe.flight import flight
    from veles_tpu_torch.observe.requests import exemplars
    from veles_tpu_torch.observe.timeseries import series
    monkeypatch.setattr(flight, "base_path",
                        str(tmp_path / "veles_flight"))
    yield
    chaos.uninstall()
    exemplars.clear()
    series.clear()
    alerts.clear()
