"""Mean per compress call of the time inside the program's ``ndzip.launch``
spans, in us: the device guard, the current stream, the ctypes call and the
CUDA runtime's memset and launch (``spans.launch_us``). Reads a record that
``spans.attach`` gave the program's spans; None on any other."""

from portbench import spans


def read(rec):
    return spans.launch_us(rec, "compress")
