"""Sharding rules and in-model hints for the production mesh."""
