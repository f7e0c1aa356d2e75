"""A helper for the port's cross-package stream tests: how decided was
each token of a JAX reference stream."""
import jax.numpy as jnp
import numpy as np

from paddle_tpu.models.gpt import _decode_forward as jax_decode_forward


def reference_margins(jax_model, prompts, streams):
    """The JAX reference's smallest top-2 logit margin per stream, over
    the positions that decided its tokens (a stream test holds only
    where the margin leaves room for float differences)."""
    cfg = jax_model.cfg
    params = jax_model.raw_parameters()
    out = []
    for p, toks in zip(prompts, streams):
        seq = np.concatenate([p, np.asarray(toks[:-1], np.int32)])[None]
        jk = jnp.zeros((cfg.num_layers, 1, seq.shape[1], cfg.num_heads,
                        cfg.hidden_size // cfg.num_heads))
        lg, _, _ = jax_decode_forward(cfg, params, jnp.asarray(seq), 0, jk,
                                      jnp.zeros_like(jk))
        top2 = np.sort(np.asarray(lg)[0, len(p) - 1:], axis=-1)[:, -2:]
        out.append(float((top2[:, 1] - top2[:, 0]).min()))
    return out
