from .generate import generate, greedy_search
from .speculative import (ngram_speculative_greedy_search,
                          speculative_greedy_search)
