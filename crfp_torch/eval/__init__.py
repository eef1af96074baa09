"""Evaluation: 4-zone streaming metrics, foveated heat-maps, MATLAB-compatible metrics, the clip evaluator."""
