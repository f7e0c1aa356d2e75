"""Models of the PyTorch/CUDA port."""
from .gpt import (GPT, GPTConfig, generate_greedy, gpt_1p3b, gpt_medium,
                  gpt_small, gpt_tiny)
from .weights import (from_jax_params, from_jax_train_state,
                      load_jax_int8_params, load_jax_params)

__all__ = ["GPT", "GPTConfig", "gpt_tiny", "gpt_small", "gpt_medium",
           "gpt_1p3b", "generate_greedy", "from_jax_params",
           "from_jax_train_state", "load_jax_params", "load_jax_int8_params"]
