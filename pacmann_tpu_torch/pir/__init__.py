"""PianoPIR parameters, DB layout and the device-resident engine."""
