# Torch twins of the host-sync and dtype fixture snippets in
# tests/analysis_fixtures/ (tests/test_torch_analysis_rules.py). PARSED
# by the linter, never imported: each *_bad.py gives the findings of its
# JAX twin on the same lines, each *_good.py none.
