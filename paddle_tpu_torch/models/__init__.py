"""Model zoo of the port: the Llama family (`LlamaConfig`,
`LlamaForCausalLM`) under the JAX package's public names."""

from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel,
                    LlamaPretrainingCriterion, load_reference_arrays)

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel",
           "LlamaPretrainingCriterion", "load_reference_arrays"]
