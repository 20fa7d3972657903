"""device_ms.vit.layer_norm (ms/image), layer "encode": device time of the
``layer_norm`` spans under ``vit`` (``models/layers.layer_norm``: norm1 and
norm2 of every block, fp32 statistics and the cast back), over the images of
the slice's ``tokenizer.encode`` spans. Read from the program's own spans
and their CUDA events (``_encode_split``); the eight ``device_ms`` metrics
are a partition of the program's device time."""
from h100bench.metrics._encode_split import device_ms


def read(run):
    return device_ms(run, "vit.layer_norm")
