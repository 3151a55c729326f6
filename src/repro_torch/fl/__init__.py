"""The federation runtime (fused homogeneous AdaBoost.F path) and partitioners."""
