"""device_ms.vit.attention (ms/image), layer "encode": device time of the
``attention`` spans under ``vit`` (``models/vit.block_apply``, around the
``mha`` / ``flash_attention`` choice: with plain ``mha`` the fp32 casts, the
score GEMM, the scaling, softmax, the cast back and P@V), over the images of
the slice's ``tokenizer.encode`` spans. Read from the program's own spans
and their CUDA events (``_encode_split``); the eight ``device_ms`` metrics
are a partition of the program's device time."""
from h100bench.metrics._encode_split import device_ms


def read(run):
    return device_ms(run, "vit.attention")
