# Port copy of centrifuger_tpu.succinct (host code, no accelerator).
from .packed import PackedSeq
from .bitvector import Bitvector
