"""An artifact of the port's `jit.save` reloaded by `jit.load` in a fresh
process that cannot import `jax` or the JAX package: the MLP with batch
norm of `port_export` (JAX's `_mlp` and its port twin), fp32 on the
CPU, gives JAX's eval forward within rtol 2e-5 / atol 2e-6 (the JAX
tests' limits). The in-process capture, save and load cases are in
`test_torch_jit_export.py`."""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np

from paddle_tpu_torch import jit
from paddle_tpu_torch.static import InputSpec
from port_export import mlps, x8  # noqa: F401
from port_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-5, atol=2e-6)


class TestSaveLoad:
    def test_fresh_process_reload_without_jax(self, mlps, tmp_path):
        jm, pm = mlps
        prefix = str(tmp_path / "mlp")
        jit.save(pm, prefix, input_spec=[InputSpec([None, 8], "float32")])
        x = x8(3, seed=3)
        np.save(str(tmp_path / "x.npy"), x)
        code = (
            "import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['paddle_tpu'] = None\n"
            f"sys.path.insert(0, {json.dumps(ROOT)})\n"
            "import numpy as np\n"
            "from paddle_tpu_torch import jit\n"
            f"m = jit.load({json.dumps(prefix)}, device='cpu')\n"
            f"x = np.load({json.dumps(str(tmp_path / 'x.npy'))})\n"
            f"np.save({json.dumps(str(tmp_path / 'out.npy'))}, "
            "m(x).detach().numpy())\n")
        r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]
        np.testing.assert_allclose(np.load(str(tmp_path / "out.npy")),
                                   np.asarray(jm(jnp.asarray(x))), **TOL)
