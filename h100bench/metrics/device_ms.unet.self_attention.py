"""device_ms.unet.self_attention (ms/image), layer "model step": device time of
the operations launched in every ``self_attention`` span (attn1 of each UNet
transformer block: the q, k, v and out projections and ``mha``, 9,216 tokens
at the first level), over the images of the slice's ``unclip.generate``
spans. The device operations launched inside the program's own spans, each
given to the innermost (``_detok_split``); the nine ``device_ms`` metrics of
the de-tokenizer are a partition of the program's device time."""
from h100bench.metrics._detok_split import device_ms


def read(run):
    return device_ms(run, "unet.self_attention")
