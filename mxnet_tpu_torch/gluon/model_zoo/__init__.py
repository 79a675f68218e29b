"""Model zoo: the GPT and BERT families (``torch.nn.Module``s) and the
vision models (Gluon blocks)."""

from . import bert, gpt, vision
