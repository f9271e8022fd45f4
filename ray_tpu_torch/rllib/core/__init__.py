"""Modules, distributions, weight conversion and the Learner."""
