"""Boosting rounds, predict-once scoring, metrics and the plan."""
