# Port copy of centrifuger_tpu.classify.params (host code, no accelerator).
"""Classifier parameters (mirrors _classifierParam, reference Classifier.hpp:17-30)."""

from dataclasses import dataclass


@dataclass
class ClassifierParam:
    max_result: int = 1              # -k
    min_hit_len: int = 0             # --min-hitlen; 0 = auto-infer
    max_result_per_hit_factor: int = 40  # --hitk-factor
    output_expanded_result: bool = False  # --expand-taxid
