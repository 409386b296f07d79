"""The paper's result tables on the port (port of ``benchmarks/common.py``
and ``benchmarks/table*_*.py``): a bench BERT trained per synthetic-GLUE
task, then PTQ / PEG / mixed precision / QAT / AdaRound evaluated on it.
Run them with ``scripts/paper_tables_torch.py``."""
