"""Scripts for the card, run as modules and never imported by the package
itself: the flash kernels' tile sweep (``sweep_flash_bwd``) and the BERT-base
pretraining bench (``bench_bert``)."""
