"""The field lies on the card: ``compress_device`` then ``int(length)``;
``decompress_device(stream[:length])`` then a synchronize."""

from portbench.harness import sync


class Entry:
    def __init__(self, program, cfg, device):
        self.program, self.device = program, device

    def prepare(self, x):
        return x

    def compress(self, x):
        stream, length = self.program.compress_device(x)
        n = int(length)
        return stream[:n], n

    def decompress(self, stream, like):
        out = self.program.decompress_device(stream, like.shape, like.dtype)
        sync(self.device)
        return out
