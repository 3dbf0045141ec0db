"""The port's entry points run on the card unless the caller asks for the CPU.

``ModelBundle.random``, ``from_state_dicts`` and ``from_dir`` default to
``device="cuda"`` and raise where there is no card; they never fall back to
the CPU on their own.  The CPU tests pass ``device="cpu"``.
"""

import inspect
import os

import pytest
import torch

from videosd_tpu_torch.pipelines import lcm_img2img as P

# One torch thread per process, set at import: every xdist worker imports
# every test module, and torch threads on every core of every worker stall
# JAX's interpreted Pallas kernels in the worker that runs them.
torch.set_num_threads(1)

_CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "examples", "toy_tiny_ckpt")
_ENTRIES = {
    "random": lambda **kw: P.ModelBundle.random("tiny", dtype=torch.float32, **kw),
    "from_state_dicts": lambda **kw: P.ModelBundle.from_state_dicts("tiny", {}, **kw),
    "from_dir": lambda **kw: P.ModelBundle.from_dir(_CKPT, **kw),
}


@pytest.mark.parametrize("name", list(_ENTRIES))
def test_entry_point_defaults_to_the_card(name):
    default = inspect.signature(getattr(P.ModelBundle, name)).parameters["device"].default
    assert default == "cuda"


@pytest.mark.parametrize("name", list(_ENTRIES))
def test_entry_point_raises_without_a_card(name):
    if torch.cuda.is_available():
        assert _ENTRIES[name]().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            _ENTRIES[name]()


@pytest.mark.parametrize("name", list(_ENTRIES))
def test_entry_point_runs_on_the_cpu_when_asked(name):
    bundle = _ENTRIES[name](device="cpu")
    assert bundle.device == torch.device("cpu")
    assert all(p.device.type == "cpu" for m in bundle.models.values() for p in m.parameters())
