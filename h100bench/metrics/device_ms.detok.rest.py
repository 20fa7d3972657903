"""device_ms.detok.rest (ms/image), layer "model step": device time of the
operations launched in the rest of ``unclip.generate``: the embedding's
noise, the CFG batch, the DDIM steps and guidance, the clamp, the pixels'
copy to the host, over the images of the slice's ``unclip.generate`` spans.
The device operations launched inside the program's own spans, each given to
the innermost (``_detok_split``); the nine ``device_ms`` metrics of the
de-tokenizer are a partition of the program's device time."""
from h100bench.metrics._detok_split import device_ms


def read(run):
    return device_ms(run, "detok.rest")
