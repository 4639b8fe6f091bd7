"""Stages: each module drives one entry of the program under test."""
