"""Reader creators (counterpart of ``paddle_tpu/reader/creator.py``):
``np_array`` and ``text_file``.  The recordio readers wait for the
``recordio`` module (ROADMAP Queue A8) and raise."""

__all__ = ["np_array", "text_file", "recordio", "open_recordio_files"]


def np_array(x):
    """Yield rows of a numpy array."""
    import numpy as np

    arr = np.asarray(x)

    def reader():
        yield from arr

    return reader


def text_file(path):
    """Yield lines of a text file, newline-stripped."""

    def reader():
        with open(path, "r") as f:
            for line in f:
                yield line.rstrip("\n")

    return reader


def recordio(paths, buf_size=100):
    raise NotImplementedError(
        "reader.creator.recordio: the recordio format is not ported to "
        "paddle_tpu_torch yet (ROADMAP Queue A8)")


def open_recordio_files(paths, num_workers=4, chunks_per_task=1,
                        prefetch=256, unpickle=True, mapper=None,
                        repeat=False):
    raise NotImplementedError(
        "reader.creator.open_recordio_files: the recordio format is not "
        "ported to paddle_tpu_torch yet (ROADMAP Queue A8)")
