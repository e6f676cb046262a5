"""Objectives, solver health, solve spec and result types."""
