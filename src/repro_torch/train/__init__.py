"""The serving pair of step builders."""
