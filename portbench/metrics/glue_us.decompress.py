"""Mean per decompress call of the ``ndzip.decompress_device`` span's self time, its
``ndzip.launch`` children left out, in us: the codec layer's checks,
allocations and choice of path (``spans.glue_us``). Reads a record that
``spans.attach`` gave the program's spans; None on any other."""

from portbench import spans


def read(rec):
    return spans.glue_us(rec, "decompress")
