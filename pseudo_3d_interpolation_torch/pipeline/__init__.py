"""Workflow steps: stage-2 POCS interpolation."""
