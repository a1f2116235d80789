# Port copy of centrifuger_tpu.taxonomy (host code, no accelerator).
from .taxonomy import Taxonomy, RANKS, rank_id, rank_string
