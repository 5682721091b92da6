"""Mean device ms a request (a batch, or one image) spent from the head's
output to the last prediction field in host memory (the port's
post-processing and the copies to the host): CUDA events recorded by
forward hooks at the port's module boundaries (``BOUNDARIES`` of the family,
families/pairnet.py), gaps included."""

from portbench.readers import span_ms


def read(rec):
    return span_ms(rec, "postprocess")
