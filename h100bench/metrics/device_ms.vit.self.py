"""device_ms.vit.self (ms/image), layer "encode": device time of the ``vit``
span's self time (``models/vit.vit_apply`` less its ``linear``,
``attention``, ``layer_norm`` and ``act`` children: residual adds, EVA's q/v
bias, patchify, class token and positions), over the images of the slice's
``tokenizer.encode`` spans. Read from the program's own spans and their CUDA
events (``_encode_split``); the eight ``device_ms`` metrics are a partition
of the program's device time."""
from h100bench.metrics._encode_split import device_ms


def read(run):
    return device_ms(run, "vit.self")
