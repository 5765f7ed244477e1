"""Program entries a traffic mix can drive, one file each."""
