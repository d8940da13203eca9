"""Configuration: settings persistence, CLI arguments, routing."""
from .settings import (SETTING_DEFAULTS, apply_setting_defaults,
                       dump_settings, load_settings, parse_settings,
                       save_experiment_settings)

__all__ = ["SETTING_DEFAULTS", "apply_setting_defaults", "dump_settings",
           "load_settings", "parse_settings", "save_experiment_settings"]
