from .bert import (
    BertConfig,
    BertForPretraining,
    BertForSequenceClassification,
    BertModel,
    BertPretrainingCriterion,
    bert_base_config,
    bert_tiny_config,
)
from .convert import params_from_paddle_tpu
from .generation import generate
from .kv_pool import PagePool
from .llama import (
    LlamaConfig,
    LlamaForCausalLM,
    LlamaPretrainingCriterion,
    PagedKVCache,
    causal_lm_loss,
)
from .serving import ContinuousBatchingEngine

__all__ = ["BertConfig", "BertForPretraining",
           "BertForSequenceClassification", "BertModel",
           "BertPretrainingCriterion", "ContinuousBatchingEngine",
           "LlamaConfig", "LlamaForCausalLM", "LlamaPretrainingCriterion",
           "PagePool", "PagedKVCache", "bert_base_config",
           "bert_tiny_config", "causal_lm_loss", "generate",
           "params_from_paddle_tpu"]
