"""The plain KLT of the frozen copy and the kernel's work count."""
