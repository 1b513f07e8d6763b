"""Tracking models of the port: the dense tracker."""
