"""The seq2seq decoder API (counterpart of
``paddle_tpu/contrib/decoder``)."""

from . import beam_search_decoder
from .beam_search_decoder import *  # noqa: F401,F403

__all__ = beam_search_decoder.__all__
