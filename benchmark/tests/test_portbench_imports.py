"""The whole-name check against JAX in a run's process."""
from __future__ import annotations

import subprocess
import sys

from portbench_small import ROOT

from benchmark import harness


def test_whole_names_are_compared():
    assert harness.forbidden_modules(["jax"]) == ["jax"]
    assert harness.forbidden_modules(["jaxlib.xla_client", "numpy"]) == ["jaxlib"]
    assert harness.forbidden_modules(["deepstructuredmixtures_tpu.models"]) == [
        "deepstructuredmixtures_tpu"]
    assert harness.forbidden_modules(["flax.linen"]) == ["flax"]
    assert harness.forbidden_modules(["deepstructuredmixtures_tpu_torch",
                                      "deepstructuredmixtures_tpu_torch.fit",
                                      "jaxtyping", "jax_like"]) == []


def test_the_harness_and_the_port_load_no_jax():
    """Everything a run imports, in a fresh process."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark import harness, check, tracing\n"
            "import benchmark.reference.dsmgp_isose\n"
            "import deepstructuredmixtures_tpu_torch, deepstructuredmixtures_tpu_torch.serve\n"
            "import deepstructuredmixtures_tpu_torch.train\n"
            "spec = harness.load_spec()\n"
            "for k in ('pass', 'train', 'serve'): harness.load_driver(k)\n"
            "for m in spec['per_layer']: harness.load_reader(m['name'])\n"
            "print(harness.forbidden_modules())\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip() == "[]"
