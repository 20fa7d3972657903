"""device_ms.preprocess (ms/image), layer "encode": device time of the
``preprocess`` span (``ops/preprocess.preprocess``: uint8 to float, CLIP
normalisation, the cast to bf16), over the images of the slice's
``tokenizer.encode`` spans. Read from the program's own spans and their CUDA
events (``_encode_split``); the eight ``device_ms`` metrics are a partition
of the program's device time."""
from h100bench.metrics._encode_split import device_ms


def read(run):
    return device_ms(run, "preprocess")
