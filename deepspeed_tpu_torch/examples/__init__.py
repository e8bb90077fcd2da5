"""Twins of the repo's examples (``examples/cifar/train.py``,
``examples/gpt2/pretrain.py``) on the PyTorch/CUDA port: the same
command lines, the same JSON configs, the same seeded weights and data.
Each has a ``main(argv)``; ``--device cpu`` runs it without a GPU."""
