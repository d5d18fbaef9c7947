"""MCTS planning with the learned model or the true environment
(counterpart of `stove_tpu/planning`)."""
