"""device_ms.encode.rest (ms/image), layer "encode": device time of the
``tokenizer.encode`` span less its ``vit`` and ``qformer`` children
(``models/seed_tokenizer.encode``: ``ln_vision``, ``encode_task``, the VQ
distances and argmin), over the images of the slice's ``tokenizer.encode``
spans. Read from the program's own spans and their CUDA events
(``_encode_split``); the eight ``device_ms`` metrics are a partition of the
program's device time."""
from h100bench.metrics._encode_split import device_ms


def read(run):
    return device_ms(run, "encode.rest")
