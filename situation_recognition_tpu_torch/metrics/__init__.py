"""Scoring: the imSitu score cards."""
