"""Coarse pose pipeline: template onboarding, the estimator, request preparation."""
