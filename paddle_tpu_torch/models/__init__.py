"""Model zoo of the port: the Llama family (`LlamaConfig`,
`LlamaForCausalLM`) and the ERNIE encoder (`ErnieConfig`,
`ErnieForSequenceClassification`, `ErnieForMaskedLM`) under the JAX
package's public names; `load_reference_arrays` crosses weights from
the JAX package by name into either."""

from .ernie import (ErnieConfig, ErnieForMaskedLM,
                    ErnieForSequenceClassification, ErnieModel, ErniePooler)
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel,
                    LlamaPretrainingCriterion, load_reference_arrays)

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel",
           "LlamaPretrainingCriterion", "load_reference_arrays",
           "ErnieConfig", "ErnieModel", "ErniePooler",
           "ErnieForSequenceClassification", "ErnieForMaskedLM"]
