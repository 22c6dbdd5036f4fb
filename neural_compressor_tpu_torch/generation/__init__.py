from .generate import generate, greedy_search
