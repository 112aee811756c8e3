"""The plain reference of the benchmark: the profile and the per-document
scores worked out again from the generated inputs, in plain torch.

It imports torch and numpy only: nothing of the program and nothing of the
JAX package. :mod:`.vocab` holds the one thing taken from the program's
source, frozen: the byte windows and the gram-id scheme. :mod:`.fit`
re-derives the profile from the training corpus, :mod:`.score` scores the
documents the timed calls labelled.
"""
