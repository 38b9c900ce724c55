"""Scenario cost models (paper §7.1-§7.3): copies of ``repro.scenarios``, numpy only."""
