"""Mean device ms a request (a batch, or one image) spent from the pixel
decoder's output to the masked-attention decoder's: CUDA events recorded
by forward hooks at the port's module boundaries (``BOUNDARIES`` of the
family, families/pairnet.py), gaps included."""

from portbench.readers import span_ms


def read(rec):
    return span_ms(rec, "decoder")
