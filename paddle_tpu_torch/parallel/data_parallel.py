"""DataParallel: the counterpart of `paddle_tpu/parallel/data_parallel.py`
(the reference's paddle.DataParallel, fluid/dygraph/parallel.py:413).

There is no reducer here either: `Trainer(mesh=)` splits the batch over
the data ranks and meets their gradients in `parallel.collective`
(`framework/trainer.py`). The wrapper places the model on the mesh's
device (one storage every rank shares: replicated parameters are not k
copies) and keeps the API: `no_sync`, `scale_loss`, and the wrapped
model's `state_dict` / `set_state_dict`.
"""
from __future__ import annotations

import contextlib

from torch import nn

from .mesh import get_mesh
from .sharding import shard_model

__all__ = ["DataParallel"]


class DataParallel(nn.Module):
    def __init__(self, layers: nn.Module, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None, mesh=None):
        super().__init__()
        self._layers = layers
        mesh = mesh or get_mesh()
        if mesh is not None:
            shard_model(layers, mesh)

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    @contextlib.contextmanager
    def no_sync(self):
        """The reference's gradient-accumulation guard. The Trainer's
        `grad_accum` already adds each rank's microbatch gradients up
        before the ranks meet, once per step."""
        yield

    def scale_loss(self, loss):
        """The loss as it is: the Trainer's loss is already the global
        batch's mean."""
        return loss

    def state_dict(self, *a, **kw):
        return self._layers.state_dict(*a, **kw)

    def set_state_dict(self, state_dict, *a, **kw):
        return self._layers.load_state_dict(state_dict, *a, **kw)

    def load_state_dict(self, state_dict, *a, **kw):
        return self._layers.load_state_dict(state_dict, *a, **kw)
