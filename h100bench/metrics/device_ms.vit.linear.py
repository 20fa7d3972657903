"""device_ms.vit.linear (ms/image), layer "encode": device time of the
``linear`` spans under ``vit`` (``models/layers.linear`` and
``linear_w8a8``: the patch embedding and each block's qkv, proj, fc1 and fc2
GEMMs with their bias adds), over the images of the slice's
``tokenizer.encode`` spans. Read from the program's own spans and their CUDA
events (``_encode_split``); the eight ``device_ms`` metrics are a partition
of the program's device time."""
from h100bench.metrics._encode_split import device_ms


def read(run):
    return device_ms(run, "vit.linear")
