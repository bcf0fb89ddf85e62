"""The evaluation CLIs (counterparts of ``scripts/eval_results/``): rule
values recomputed from MIDI, rule-loss tables, mgeval quality tables and
their pivots, edit bin accuracy and FAD. Each has ``main(argv=None)``."""
