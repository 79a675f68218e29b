"""Model zoo: the GPT and BERT families, the encoder-decoder Transformer
and the vision models (ResNet, ViT), all Gluon blocks."""

from . import bert, gpt, transformer, vision
from .bert import (BERTModel, BERTPretrainLoss, TransformerEncoder,
                   TransformerEncoderLayer, bert_base, bert_large,
                   bert_tiny)
from .gpt import (CachedDecoder, GPTLMLoss, GPTModel, gpt2_medium,
                  gpt2_small, gpt_tiny, speculative_decode)
