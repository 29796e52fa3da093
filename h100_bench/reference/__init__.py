"""The plain reference of the benchmark's cells.

Frozen copies, in plain PyTorch and numpy, of what the cells' timed paths
compute: the bank layout, the draws and the synthesis sum, the features and
labels (``data``), vad v8 (``vad``) and the density EfficientNet-B4
(``effnet``) on shared layers (``layers``), the losses, AGC, Keras Adam and
AdaBelief (``train``). Nothing here imports ``challenge_tpu_torch``,
``challenge_tpu`` or JAX; the benchmark hands the same sources and drawn
weights to the program and to this package, and the reference works out
again everything the program derives from them, the draws from the seeds
included.

A configuration's file names its model module here by ``reference``; each
such module has ``build(config) -> nn.Module``.
"""
