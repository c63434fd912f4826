"""Frozen counts: per configuration, ``<config>.py`` gives the model
FLOPs of one grad-step and the bytes each gather launch of a macro-step
must move; ``peaks.json`` the card's data-sheet peaks.

The FLOP convention (``nets.py``): 2 FLOPs per multiply-accumulate of
the convolutions and matrix products the algorithm needs, counted as
``torch.utils.flop_counter.FlopCounterMode`` counts them (the tests hold
the two equal): the online net's forward over the trained inputs, its
backward (the weight gradients of every layer and the input gradients
of every layer but the first, whose input is data), and the bootstrap
forwards (online and target) without gradients. Elementwise work, the
optimizer, the replay and anything recomputed are not counted.
"""
