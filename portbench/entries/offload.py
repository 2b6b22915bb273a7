"""The field lies in host memory: ``Offloader.compress`` gives a host
stream, ``Offloader.decompress`` a host array. On the CPU (tests) the plain
versions stand in for the card."""


class Entry:
    def __init__(self, program, cfg, device):
        backend = "cuda" if device.type == "cuda" else "torch"
        self.offloader = program.Offloader(cfg["dtype"], len(cfg["shape"]), backend=backend)

    def prepare(self, x):
        return x.cpu().numpy()

    def compress(self, x):
        stream, _ = self.offloader.compress(x)
        return stream, int(stream.size)

    def decompress(self, stream, like):
        return self.offloader.decompress(stream, like.shape)
