"""Model zoo: the GPT and BERT families, the encoder-decoder Transformer,
SSD and the vision models, all Gluon blocks, and ``model_store``'s local
parameter files."""

from . import bert, gpt, model_store, ssd, transformer, vision
from .bert import (BERTModel, BERTPretrainLoss, TransformerEncoder,
                   TransformerEncoderLayer, bert_base, bert_large,
                   bert_tiny)
from .gpt import (CachedDecoder, GPTLMLoss, GPTModel, gpt2_medium,
                  gpt2_small, gpt_tiny, speculative_decode)
from .model_store import get_model_file, purge
from .ssd import SSD, SSDTrainLoss, ssd_detect
