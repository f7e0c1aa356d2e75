"""`paddle_tpu_torch.testing`: test-support utilities shipped with the
package (not under `tests/`), because they instrument production code
paths and production code must be able to import them.

Current contents: `faults`, the deterministic fault-injection harness
behind the serving engine's recovery paths."""
from . import faults

__all__ = ["faults"]
