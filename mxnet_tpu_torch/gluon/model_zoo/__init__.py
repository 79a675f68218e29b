"""Model zoo: the GPT and BERT families and the vision models (ResNet,
ViT), all Gluon blocks."""

from . import bert, gpt, vision
