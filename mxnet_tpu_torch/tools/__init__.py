"""Command-line tools of the port (counterpart of the reference's
``tools/``): ``python -m mxnet_tpu_torch.tools.im2rec`` and
``python -m mxnet_tpu_torch.tools.launch``."""
